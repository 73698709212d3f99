"""Port parity for the multi-device frame (``tinyrenderer_tpu_torch.parallel``)
on the CPU.

Unit tests in one process: ``raster.translate_setup_y`` against the jitted
JAX function, the band sky, band SSR with gathered taps, and the shadow
gates of a band with a halo. Whole frames: the port's sharded frame over
four gloo ranks on the CPU (``parallel.launch``, spawned once for the
module, every case in one job) against JAX ``compiled_sharded_frame`` on
conftest's virtual CPU devices, and against the port's single-card frame
under ``tests/test_sharded.py``'s bars. The world is ``scene.demo``'s demo
world at ``test_sharded.py``'s TINY configuration, each side built by its
own package.
"""

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import planes
import pytest
import torch

from tinyrenderer_tpu import parallel as jparallel
from tinyrenderer_tpu.config import RenderConfig as JRenderConfig
from tinyrenderer_tpu.ops import env as jenv
from tinyrenderer_tpu.ops import raster as jraster
from tinyrenderer_tpu.render.engine import Engine as JEngine
from tinyrenderer_tpu.scene import demo as jdemo
from tinyrenderer_tpu_torch.config import RenderConfig
from tinyrenderer_tpu_torch.ops import env as tenv
from tinyrenderer_tpu_torch.ops import post as tpost
from tinyrenderer_tpu_torch.ops import raster as traster
from tinyrenderer_tpu_torch.ops import shadows as tshadows
from tinyrenderer_tpu_torch.parallel import jobs, sharded
from tinyrenderer_tpu_torch.parallel.launch import launch
from tinyrenderer_tpu_torch.render import frame as tframe
from tinyrenderer_tpu_torch.scene import demo

# tests/test_sharded.py's TINY
TINY = RenderConfig(
    width=128, height=64, tile_h=16, tile_w=128, bin_capacity=128,
    shadow_size=128, shadow_tile=128, shadow_bin_capacity=128,
    env_size=32, irradiance_size=8, texture_size=64, mip_levels=4,
    max_vertices=4096, max_triangles=2048, max_instances=64,
    use_pallas=False, enable_ssr=False,
)
RANKS = 4
R = dataclasses.replace


def _t(a):
    return torch.from_numpy(np.array(a))


# ---- unit tests ----------------------------------------------------------------

@pytest.mark.parametrize("y0", [0.0, 336.0, 270.0, 17.25, -3.5])
def test_translate_setup_y_bit_equal(y0):
    """The band setup's rows, bbox and screen corners equal the jitted JAX
    function's bit for bit: XLA contracts ``c + a_y * y0`` into one fused
    multiply-add, which the port spells out. Random setups of 1037 rows."""
    rng = np.random.default_rng(int(abs(y0) * 4) + 1)
    T = 1037
    rows = (rng.standard_normal((T, 16))
            * rng.uniform(0.01, 100.0, (T, 16))).astype(np.float32)
    bbox = rng.uniform(-50.0, 1100.0, (T, 4)).astype(np.float32)
    screen = rng.uniform(-50.0, 1100.0, (T, 3, 2)).astype(np.float32)
    inv_w = rng.uniform(0.1, 2.0, (T, 3)).astype(np.float32)
    z = rng.uniform(0.0, 1.0, (T, 3)).astype(np.float32)
    valid = rng.uniform(size=T) > 0.2

    @jax.jit
    def jfn(rows, valid, bbox, screen, inv_w, z, y0):
        s = jraster.translate_setup_y(jraster.TriangleSetup(
            rows=rows, valid=valid, bbox=bbox, screen=screen, inv_w=inv_w,
            z_ndc=z), y0)
        return s.rows, s.bbox, s.screen

    want = [np.asarray(a) for a in jfn(rows, valid, bbox, screen, inv_w, z,
                                       np.float32(y0))]
    got = traster.translate_setup_y(traster.TriangleSetup(
        rows=_t(rows), valid=_t(valid), bbox=_t(bbox), screen=_t(screen),
        inv_w=_t(inv_w), z_ndc=_t(z)), y0)
    for g, w in zip((got.rows, got.bbox, got.screen), want):
        np.testing.assert_array_equal(g.numpy(), w)


def _sky_inputs():
    rng = np.random.default_rng(3)
    cube = rng.uniform(0.0, 4.0, (6, 16, 16, 3)).astype(np.float32)
    cam = demo.build_demo_camera(128, 96).to_raw()
    return cube, cam[64:80].reshape(4, 4), cam[32:48].reshape(4, 4)[:3, :3]


@pytest.mark.parametrize("y0,rows", [(0, 24), (24, 24), (72, 24), (40, 8)])
def test_band_sky_rows(y0, rows):
    """The sky of rows [y0, y0 + rows) of a 96-row frame equals the whole
    frame's rows, dense and on compacted blocks, and the JAX band
    function's."""
    cube, proj_inv, rot = _sky_inputs()
    W, H = 128, 96
    full = tenv.skybox_colors(_t(cube), _t(proj_inv), _t(rot), W, H)
    band = tenv.skybox_colors(_t(cube), _t(proj_inv), _t(rot), W, rows,
                              y0=y0, full_height=H)
    np.testing.assert_array_equal(band.numpy(), full[y0:y0 + rows].numpy())
    jband = jenv.skybox_colors(jnp.asarray(cube), jnp.asarray(proj_inv),
                               jnp.asarray(rot), W, rows, y0=y0,
                               full_height=H)
    np.testing.assert_array_equal(band.numpy(), np.asarray(jband))
    bh, bw, nbx = 8, 32, W // 32
    slots = np.array([0, 2, -1, rows // bh * nbx - 1], np.int32)
    blocks = tenv.skybox_colors_blocks(_t(cube), _t(proj_inv), _t(rot),
                                       _t(slots), bh, bw, nbx, W, rows,
                                       y0=y0, full_height=H)
    jblocks = jenv.skybox_colors_blocks(
        jnp.asarray(cube), jnp.asarray(proj_inv), jnp.asarray(rot),
        jnp.asarray(slots), bh, bw, nbx, W, rows, y0=y0, full_height=H)
    np.testing.assert_array_equal(blocks.numpy(), np.asarray(jblocks))
    for k, s in enumerate(slots):
        if s >= 0:
            by, bx = divmod(int(s), nbx)
            np.testing.assert_array_equal(
                blocks[k].numpy(),
                band[by * bh:(by + 1) * bh, bx * bw:(bx + 1) * bw].numpy())


def test_band_ssr_with_gathered_taps():
    """SSR of each band, its per-pixel inputs band-local and its taps on
    the whole frame's depth and HDR, equals the whole frame's SSR on the
    band's rows."""
    rng = np.random.default_rng(5)
    H, W, bh = 64, 96, 16
    cam = demo.build_demo_camera(W, H).to_raw()
    depth = _t(rng.uniform(0.0, 1.0, (H, W)).astype(np.float32))
    hdr = _t(rng.uniform(0.0, 3.0, (H, W, 3)).astype(np.float32))
    pos = _t(rng.uniform(-4.0, 4.0, (H, W, 3)).astype(np.float32))
    n = rng.standard_normal((H, W, 3)).astype(np.float32)
    normal = _t(n / np.linalg.norm(n, axis=-1, keepdims=True))
    mask = _t(rng.uniform(size=(H, W)) > 0.2)
    rough = _t(rng.uniform(0.0, 0.6, (H, W)).astype(np.float32))
    vp, campos = _t(cam[0:16].reshape(4, 4)), _t(cam[80:83])
    th, st = torch.tensor(0.25), torch.tensor(1.0)
    full = tpost.screen_space_reflections(hdr, depth, pos, normal, vp, campos,
                                          th, st, mask=mask, roughness=rough)
    assert (full != hdr).any(), "no reflection in the test frame"
    for y0 in range(0, H, bh):
        rows = slice(y0, y0 + bh)
        band = tpost.screen_space_reflections(
            hdr[rows], depth, pos[rows], normal[rows], vp, campos, th, st,
            mask=mask[rows], roughness=rough[rows], tap_hdr=hdr, y0=y0)
        np.testing.assert_array_equal(band.numpy(), full[rows].numpy())


def _vis_fns(edge_z: float):
    """Two lights whose visibility compares the position's own components
    (as tests/test_torch_repairs.py's gates); the second's shadow edge is
    the plane z = ``edge_z``."""
    def vis_all(p):
        return torch.stack([p[..., 0] > p[..., 1], p[..., 2] < edge_z],
                           -1).to(torch.float32)

    def vis_slot(pos_c, li_c):
        return torch.where((li_c == 0)[:, None, None],
                           pos_c[..., 0] > pos_c[..., 1],
                           pos_c[..., 2] < edge_z).to(torch.float32)
    return vis_all, vis_slot


@pytest.mark.parametrize("scale", [2, 4])
def test_band_gates_with_halo(scale):
    """The gates of each band, its coarse grid closed by the neighbour
    bands' boundary rows (a closure over the whole frame's coarse grid,
    the frame's own rows at its top and bottom), equal the whole frame's
    gates on the band's rows. A shadow edge just above the first seam
    (pixel row 31 dark, the last coarse sample above it lit) is one that a
    band without the halo misses."""
    H, W, bh = 96, 128, 32
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    pos = _t(np.stack([xs / 8.0 - 6.0,
                       np.sin(xs / 9.0) + np.cos(ys / 5.0) - 1.5,
                       ys / 8.0 - 4.0], -1).astype(np.float32))
    vis_all, vis_slot = _vis_fns(30.5 / 8.0 - 4.0)
    full, _ = tshadows.gate_refined_visibility(vis_all, vis_slot, pos, scale,
                                               0, block_dims=(8, 16))
    lo = vis_all(pos[::scale, ::scale]) > 0.0
    hl = bh // scale
    seams_differ = False
    for k in range(H // bh):
        def halo(band_lo, k=k):
            top, bot = k * hl, (k + 1) * hl
            above = band_lo[:1] if k == 0 else lo[top - 1:top]
            below = band_lo[-1:] if bot == lo.shape[0] else lo[bot:bot + 1]
            return above.to(torch.uint8), below.to(torch.uint8)
        rows = slice(k * bh, (k + 1) * bh)
        band, _ = tshadows.gate_refined_visibility(
            vis_all, vis_slot, pos[rows], scale, 0, block_dims=(8, 16),
            halo_exchange=halo)
        np.testing.assert_array_equal(band.numpy(), full[:, rows].numpy())
        edge_pad, _ = tshadows.gate_refined_visibility(
            vis_all, vis_slot, pos[rows], scale, 0, block_dims=(8, 16))
        seams_differ |= not torch.equal(edge_pad, band)
    assert seams_differ, "the test frame has no shadow edge at a seam"


# ---- whole frames --------------------------------------------------------------

def _cases(cfg, cams2):
    """test_sharded.py's cases: (name, frame config, dp, job extras)."""
    s4 = sharded.sharded_config(cfg, RANKS)
    return {
        "base": (s4, 1, {}),
        "dp2_two_cameras": (sharded.sharded_config(cfg, 2), 2,
                            {"cams": cams2}),
        "fused_resolve": (R(s4, use_pallas=True, fused_resolve=True), 1, {}),
        "fused_shading": (sharded.sharded_config(R(cfg, use_pallas=True),
                                                 RANKS), 1, {}),
        "stream_bf16": (R(s4, use_pallas=True, stream_raster=True,
                          bf16_attrs=True, fused_shading=False), 1,
                        {"scatter_min_t": 0}),
        "ssr": (R(s4, enable_ssr=True), 1,
                {"params": {tframe.PARAM_SSR_STRENGTH: 1.0}}),
        "render_scale": (R(s4, render_scale_pct=50), 1, {}),
        "compact_sky": (sharded.sharded_config(
            R(cfg, sky_block_capacity=4096, sky_scale=8), RANKS), 1, {}),
        # the steady frame: render_shadow_atlas_sharded once, then the frame
        "cached_atlas": (s4, 1, {"atlas": "cached"}),
    }


CASES = ["base", "dp2_two_cameras", "fused_resolve", "fused_shading"]
# tests/test_torch_sharded_more.py runs the others, so that --dist loadfile
# spreads the JAX compiles
MORE_CASES = ["stream_bf16", "ssr", "render_scale", "compact_sky"]


class _Ranks:
    """The port's ranks, run in a thread while the JAX frames compile."""

    def __init__(self, job):
        self.result = self.error = None
        self.thread = threading.Thread(target=self._run, args=(job,))
        self.thread.start()

    def _run(self, job):
        try:
            self.result = launch(planes.sharded_frame_job, RANKS, "gloo",
                                 "cpu", job, timeout_s=300)
        except Exception as e:      # re-raised in the test that reads it
            self.error = e

    def get(self):
        self.thread.join(timeout=400)
        assert not self.thread.is_alive(), "the ranks did not finish"
        if self.error is not None:
            raise self.error
        return self.result


def make_world(names):
    """The port's engine of the demo world, its capacities settled over
    frames from TINY; the JAX engine packed at the settled configuration;
    the frame cases ``names``; the port's ranks started on them."""
    te = jobs.make_engine(("demo", {}), TINY, "cpu")
    for _ in range(8):
        cfg = te.cfg
        te.run_frame(0.0)
        if te.cfg == cfg:
            break
    cfg = te.cfg
    je = JEngine.from_world(jdemo.build_demo_world(),
                            camera=jdemo.build_demo_camera(TINY.width,
                                                           TINY.height),
                            cfg=JRenderConfig(**dataclasses.asdict(cfg)))
    je.update(0.0)
    je._drain_actions()
    je._ensure_env()
    assert dataclasses.asdict(je.cfg) == dataclasses.asdict(cfg)
    cam2 = demo.build_demo_camera(cfg.width, cfg.height)
    cam2.position = np.array([-10.0, 7.0, 5.0], np.float32)
    cam2.look_at(np.zeros(3, np.float32))
    cams2 = np.stack([te.camera.to_raw(), cam2.to_raw()])
    cases = {k: v for k, v in _cases(cfg, cams2).items() if k in names}
    job = dict(device="cpu", backend="gloo", worlds=[dict(
        world=("demo", {}), cfg=dataclasses.asdict(cfg),
        cases=[dict(name=k, cfg=dataclasses.asdict(c), dp=dp, **extra)
               for k, (c, dp, extra) in cases.items()])])
    assert te._atlas is not None
    return dict(je=je, te=te, cases=cases, ranks=_Ranks(job), jax_out={},
                single={})


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """This process's torch threads cut to 2 while the module runs: its
    four ranks and the JAX compiles share the host's cores with it."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world():
    return make_world(CASES)


def _port(world, case, form="port"):
    """Rank 0's result of ``case`` under the plane form ``form`` of
    ``planes.FORMS`` (the port's own planes by default)."""
    results = world["ranks"].get()
    i = (list(world["cases"]).index(case)
         + planes.FORMS.index(form) * len(world["cases"]))
    assert len({r[i]["digest"] for r in results}) == 1, \
        "the ranks returned different frames"
    return results[0][i]


def _jax_frame(world, case):
    """JAX compiled_sharded_frame of the case on RANKS virtual devices."""
    if case not in world["jax_out"]:
        je = world["je"]
        cfg, dp, extra = world["cases"][case]
        params = np.array(je.params)
        for i, v in extra.get("params", {}).items():
            params[i] = v
        cams = extra.get("cams", je.camera.to_raw()[None])
        old = jraster._SCATTER_MIN_T
        jraster._SCATTER_MIN_T = extra.get("scatter_min_t", old)
        try:
            out = jparallel.compiled_sharded_frame(
                JRenderConfig(**dataclasses.asdict(cfg)),
                jparallel.make_mesh(RANKS, dp=dp))(
                je._pack.scene, je._packer.pool_for(je.cfg), je._pack.lights,
                jnp.asarray(cams), jnp.asarray(params), je._env)
            world["jax_out"][case] = jax.tree.map(np.asarray, out)
        finally:
            jraster._SCATTER_MIN_T = old
    return world["jax_out"][case]


def _sdr_diff(a, b):
    return np.abs(a.astype(np.int16) - b.astype(np.int16)).max(axis=-1)


def check_matches_jax(world, case):
    """The port's sharded frame over gloo ranks against JAX
    compiled_sharded_frame: under the JAX package's rounding of the raster
    planes (tests/planes.py), pick ids equal, depth within 1e-6, the
    tone-mapped frame within 1 LSB, every monitor equal; every rank
    returned the same frame. The port's own frame is held to the JAX
    frame and the float64 planes' frame by ``planes.assert_nearer`` and
    the edge-aware comparator, every monitor of it equal to the JAX
    frame's."""
    j = _jax_frame(world, case)
    names = ("pick_id", "depth", "sdr")
    own = _port(world, case)["out"]
    f64 = {k: _port(world, case, "float64")["out"][k] for k in names}
    jax = planes.frame_fields(j, names)
    planes.assert_nearer({k: own[k] for k in names}, jax, f64)
    planes.assert_sdr(own["sdr"], jax, f64)
    for f in jobs.FIELDS[4:10]:
        assert own[f].tolist() == np.asarray(getattr(j, f)).tolist(), f
    t = _port(world, case, "jax")["out"]
    assert t["sdr"].shape == j.sdr.shape
    np.testing.assert_array_equal(t["pick_id"], j.pick_id)
    np.testing.assert_allclose(t["depth"], j.depth, rtol=0, atol=1e-6)
    assert _sdr_diff(t["sdr"], j.sdr).max() <= 1
    for f in jobs.FIELDS[4:10]:
        assert t[f].tolist() == np.asarray(getattr(j, f)).tolist(), f
    assert len(np.unique(t["pick_id"])) > 2 and (t["pick_id"] == 0).any()


SHADOW_FIELDS = ("shadow_size", "shadow_tile", "shadow_bin_capacity",
                 "bin_big_capacity", "shadow_bf16")


def _single(world, case, cam_index=0):
    """The port's single-card frame of the case's configuration, over the
    engine's atlas (every case keeps the engine's shadow fields), once."""
    key = (case, cam_index)
    if key not in world["single"]:
        te = world["te"]
        cfg, dp, extra = world["cases"][case]
        assert all(getattr(cfg, f) == getattr(te.cfg, f)
                   for f in SHADOW_FIELDS)
        params = te.params.clone()
        for i, v in extra.get("params", {}).items():
            params[i] = v
        cams = extra.get("cams", te.camera.to_raw()[None])
        old = traster._SCATTER_MIN_T
        traster._SCATTER_MIN_T = extra.get("scatter_min_t", old)
        try:
            world["single"][key] = tframe.render_frame(
                te._pack.scene, te._packer.pool_for(cfg, "cpu"),
                te._pack.lights, _t(cams[cam_index]), params,
                te._ensure_env(), cfg, te._atlas)
        finally:
            traster._SCATTER_MIN_T = old
    return world["single"][key]


def _interior(n_rows, band_h):
    interior = np.ones(n_rows, bool)
    for k in range(n_rows // band_h + 1):
        interior[max(0, k * band_h - 1):k * band_h + 1] = False
    return interior


def check_matches_single_card(world, case):
    """The port's sharded frame against the port's single-card frame of the
    same sharded_config, under tests/test_sharded.py's bars for the case
    (:60-76 base, :166-175 fused shading, :190-205 stream + bf16, :254-264
    SSR, :282-293 render scale, :312-317 compact sky, and the base bars
    for each camera of the dp batch and for fused_resolve)."""
    port = _port(world, case)
    out, band_h = port["out"], port["band_h"]
    n_cams = out["sdr"].shape[0]
    for c in range(n_cams):
        single = _single(world, case, c)
        a, pick = out["sdr"][c], out["pick_id"][c]
        d = _sdr_diff(a, single.sdr.numpy())
        sp_pick = single.pick_id.numpy()
        if case == "render_scale":
            assert a.shape == (TINY.height, TINY.width, 3)
            assert (d > 1).mean() < 2e-2, f"{(d > 1).sum()} pixels differ"
            assert (pick == sp_pick).mean() > 0.98
            continue
        if case == "compact_sky":
            sky = sp_pick == 0
            assert sky.sum() > 50, "no visible sky in the test view"
            np.testing.assert_array_equal(a[sky], single.sdr.numpy()[sky])
            continue
        np.testing.assert_array_equal(pick, sp_pick)
        if case == "stream_bf16":
            assert (d > 2).mean() < 0.01, f"{(d > 2).sum()} pixels differ"
            continue
        np.testing.assert_allclose(out["depth"][c], single.depth.numpy(),
                                   rtol=0, atol=1e-6)
        interior = _interior(d.shape[0], band_h)
        if case == "ssr":
            assert (d > 1).mean() < 1e-2, f"{(d > 1).sum()} pixels differ"
            assert (d[interior] <= 1).mean() > 0.999
            continue
        assert (d > 1).mean() < 5e-3, f"{(d > 1).sum()} pixels differ"
        assert (d[interior] <= 1).all(), "interior rows must match"


@pytest.mark.parametrize("case", CASES)
def test_sharded_frame_matches_jax(world, case):
    check_matches_jax(world, case)


@pytest.mark.parametrize("case", CASES)
def test_sharded_frame_matches_single_card(world, case):
    check_matches_single_card(world, case)


def test_sharded_config_pads_height():
    cfg = sharded.sharded_config(TINY, 8)
    assert cfg.tiles_y % 8 == 0 and cfg.height == 8 * TINY.tile_h
    assert not sharded.sharded_config(R(TINY, bf16_attrs=True,
                                        fused_shading=True, tile_h=8),
                                      8).fused_shading

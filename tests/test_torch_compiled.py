"""The compiled frame (``render/compiled.py``, ``frame.compiled_frame``,
``frame.compiled_shadow_atlas``, ``reload.invalidate_compiled_frames``) on
the CPU.

- The caches per config behave as the reference's (``cache_info()`` step
  for step), and the port's invalidation also drops the atlas cache.
- On the CPU a compiled function is the plain call: bit-equal to
  ``render_frame``, and on ``entry()``'s 256x128 demo world held against
  the JAX ``compiled_frame`` (jitted; Pallas in interpret mode).
- The CUDA graph's protocol through a stand-in that replays as a graph
  does (:class:`StubGraph`): the key, the slot-copy rule, the launch
  counters, and the engine rendering its settled frames through both
  compiled functions, equal to the eager frames across a camera orbit, a
  ``set_param`` and a repack; a reload drops the compiled frames.
- The three places that uploaded through pageable memory inside a frame
  (illegal in a capture) upload nothing and render what they rendered.
"""

import contextlib
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import planes
import pytest
import torch

import __graft_entry__ as graft
from tinyrenderer_tpu.config import RenderConfig as JRenderConfig
from tinyrenderer_tpu.ops import sampling as jsampling
from tinyrenderer_tpu.render import frame as jframe
from tinyrenderer_tpu.render import reload as jreload
from tinyrenderer_tpu.render.engine import Engine as JEngine
from tinyrenderer_tpu.scene import demo as jdemo
from tinyrenderer_tpu.utils import verify
from tinyrenderer_tpu_torch.config import RenderConfig
from tinyrenderer_tpu_torch.entry import small_config
from tinyrenderer_tpu_torch.ops import raster, sampling
from tinyrenderer_tpu_torch.ops.fp import fma
from tinyrenderer_tpu_torch.render import compiled
from tinyrenderer_tpu_torch.render import frame as tframe
from tinyrenderer_tpu_torch.render import reload as treload
from tinyrenderer_tpu_torch.render.engine import Engine
from tinyrenderer_tpu_torch.scene import demo

FIELDS = [f.name for f in dataclasses.fields(tframe.FrameOutput)]


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Six test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _copy_into(dst, src):
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
    elif dataclasses.is_dataclass(dst):
        for f in dataclasses.fields(dst):
            _copy_into(getattr(dst, f.name), getattr(src, f.name))
    elif isinstance(dst, (tuple, list)):
        for a, b in zip(dst, src):
            _copy_into(a, b)


class StubGraph:
    """A CUDA graph's semantics on the CPU: the capture records the
    function and its outputs; a replay runs it again on the same argument
    slots and writes into the captured outputs. A replay runs no Python,
    so the kernels' counters are left as they were."""

    def __init__(self, device):
        self.device = device

    def warm_up(self, run):
        run()

    def capture(self, run):
        self.run = run
        self.out = run()
        return self.out

    def replay(self):
        counts = compiled.launch_counts()
        _copy_into(self.out, self.run())
        now = compiled.launch_counts()
        compiled.add_launches({k: counts[k] - now[k] for k in counts})


@pytest.fixture
def stub(monkeypatch):
    monkeypatch.setattr(compiled, "capture_backend", StubGraph)


@pytest.fixture(scope="module")
def engine():
    """The port's engine on the demo world at 64x32 (a 64-texel shadow
    atlas), settled: the one engine of the graph-protocol tests."""
    cfg = dataclasses.replace(small_config(), width=64, height=32,
                              tile_w=64, shadow_size=64, shadow_tile=64)
    eng = Engine.from_world(demo.build_demo_world(), cfg=cfg, device="cpu")
    eng.run_frame(0.0)
    assert eng._settled
    return eng


def _args(eng):
    """The engine's frame arguments, the camera as its frame uploads it."""
    return (eng._pack.scene, eng._packer.pool_for(eng.cfg, eng.device),
            eng._pack.lights, torch.from_numpy(eng.camera.to_raw()),
            eng.params, eng._ensure_env())


def _equal(a: tframe.FrameOutput, b: tframe.FrameOutput):
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and torch.equal(x, y), f


# ---- the caches ----------------------------------------------------------------

def test_compiled_caches_per_config_like_the_reference():
    """Same object for equal configs, an LRU of 8, step for step the
    reference's ``cache_info()``; ``invalidate_compiled_frames()`` clears
    both of the port's caches, where the reference keeps its atlas cache."""
    widths = [16 * (i + 1) for i in range(10)]
    order = [0, 1, 2, 0, 3, 4, 5, 6, 7, 8, 9, 0, 1, 2, 9, 5]
    pairs = ((tframe.compiled_frame, jframe.compiled_frame),
             (tframe.compiled_shadow_atlas, jframe.compiled_shadow_atlas))
    for t_fn, j_fn in pairs:
        t_fn.cache_clear()
        j_fn.cache_clear()
        for i in order:
            a = t_fn(RenderConfig(width=widths[i]))
            j_fn(JRenderConfig(width=widths[i]))
            assert t_fn.cache_info() == j_fn.cache_info(), i
            assert isinstance(a, compiled.CompiledFn)
        assert t_fn(RenderConfig(width=16)) is t_fn(RenderConfig(width=16))
        assert t_fn.cache_info().currsize == 8
    treload.invalidate_compiled_frames()
    assert tframe.compiled_frame.cache_info().currsize == 0
    assert tframe.compiled_shadow_atlas.cache_info().currsize == 0
    jreload.invalidate_compiled_frames()
    assert jframe.compiled_frame.cache_info().currsize == 0
    assert jframe.compiled_shadow_atlas.cache_info().currsize == 8


# ---- the CPU path ----------------------------------------------------------------

def test_compiled_frame_on_the_cpu_matches_the_reference():
    """``compiled_frame(cfg)(*args)`` (the atlas inline) is
    ``render_frame`` bit for bit on the CPU, and renders the JAX
    ``compiled_frame``'s frame on ``entry()``'s world and arguments, the
    environment the same for both: pick ids and depth equal, SDR through
    the edge-aware comparator."""
    eng = Engine.from_world(demo.build_demo_world(), cfg=small_config(),
                            device="cpu")
    eng.update(0.0)
    eng._drain_actions()
    args = _args(eng)
    cfg, env = eng.cfg, args[5]
    t_out = tframe.compiled_frame(cfg)(*args)
    _equal(t_out, tframe.render_frame(*args, cfg))
    jeng = JEngine.from_world(jdemo.build_demo_world(), cfg=graft._small_cfg())
    jeng.update(0.0)
    jcfg = jeng.cfg
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    jenv = jframe.EnvGPU(*(jnp.asarray(getattr(env, f).numpy())
                           for f in jframe.EnvGPU._fields))
    j_out = jframe.compiled_frame(jcfg)(
        jeng._pack.scene, jeng._packer.pool_for(jcfg), jeng._pack.lights,
        jnp.asarray(jeng.camera.to_raw()), jeng.params, jenv)
    # the parity decision (tests/planes.py): equal under the JAX package's
    # rounding of the raster planes; the port's own frame held to the JAX
    # frame by planes.hold_frame
    under_jax, f64 = planes.beside(lambda: tframe.compiled_frame(cfg)(*args))
    planes.hold_frame(t_out, j_out, f64)
    t_out = under_jax
    jp = np.asarray(j_out.pick_id)
    assert np.array_equal(t_out.pick_id.numpy(), jp)
    assert np.array_equal(t_out.depth.numpy(), np.asarray(j_out.depth))
    res = verify.edge_aware_compare(t_out.sdr.numpy(), np.asarray(j_out.sdr),
                                    pick=jp)
    assert res["status"] == "pass", res
    assert len(np.unique(jp)) >= 3 and (jp == 0).any()


# ---- the graph protocol, through the stand-in ------------------------------------

def test_key_is_the_static_layout(stub):
    """An equal layout reuses its entry, new texels and all; another pool
    layout, another shape, an atlas or a sky cube where there was None
    (or the reverse) gets an entry of its own. Every call returns what the
    function returns."""
    mips = [np.random.default_rng(0).uniform(0, 1, (2, s, s, 9))
            .astype(np.float32) for s in (8, 4, 2)]
    pool = sampling.pack_texture_pool(mips, windowed=True, u8=True)

    def fn(pool, x, env, atlas=None):
        y = x + pool.texels[:4, 0].float().sum() + len(pool.level_sizes)
        if env.sky_rgbe is not None:
            y = y + env.sky_rgbe.float().mean()
        return y if atlas is None else y * atlas.sum()

    cf = compiled.CompiledFn(fn)
    x = torch.arange(6, dtype=torch.float32)
    env = tframe.EnvGPU(env_cube=torch.ones(2), irradiance=torch.ones(2),
                        irradiance_sh=torch.ones(9, 3))
    sky = dataclasses.replace(
        env, sky_rgbe=torch.full((4,), 3, dtype=torch.uint8))
    calls = [
        ((pool, x, env), 1),
        ((dataclasses.replace(pool, texels=pool.texels + 1), x, env), 1),
        ((sampling.pack_texture_pool(mips, windowed=True, u8=True,
                                     morton=True), x, env), 2),
        ((sampling.pack_texture_pool(mips[:2], windowed=True, u8=True), x,
          env), 3),
        ((pool, torch.arange(7, dtype=torch.float32), env), 4),
        ((pool, x, env, torch.ones(3)), 5),
        ((pool, x, sky), 6),
        ((pool, x, env), 6),
        ((sampling.pack_native_pool([[m[0] for m in mips]], windowed=True),
          x, env), 7)]
    for args, n in calls:
        assert torch.equal(cf(*args), fn(*args))
        assert len(cf._entries) == n


def test_slots_copy_rule(stub):
    """Small tensors are copied at every call; a large one only when its
    identity or its version changed; outputs are fresh tensors."""
    def fn(big, small):
        return big.sum(0) + small

    cf = compiled.CompiledFn(fn)
    big = torch.arange(2048, dtype=torch.float32).reshape(1024, 2)  # 8 KiB
    small = torch.ones(2)
    out = cf(big, small)
    assert torch.equal(out, fn(big, small))
    entry, = cf._entries.values()
    assert out is not entry.out
    slot_big, slot_small = entry.args
    slot_big.zero_()
    slot_small.zero_()
    # unchanged big tensor: its slot is not refilled; the small one is
    assert torch.equal(cf(big, small), small)
    big.add_(1.0)                                    # in place: a new version
    assert torch.equal(cf(big, small), fn(big, small))
    other = big.clone()                              # another tensor
    slot_big.zero_()
    assert torch.equal(cf(other, small), fn(other, small))
    out.fill_(-1.0)                                  # a caller's own copy
    assert torch.equal(cf(other, small), fn(other, small))


def test_slots_lie_on_the_graph_device(monkeypatch):
    """The slots are allocated on the backend's device, whatever device an
    argument lies on (the engine hands a compiled frame its camera in host
    memory): here a stand-in on the meta device takes host tensors."""
    monkeypatch.setattr(compiled, "capture_backend",
                        lambda device: StubGraph(torch.device("meta")))
    cf = compiled.CompiledFn(lambda a, b: (a, b))
    out = cf(torch.ones(3), torch.ones(2))
    entry, = cf._entries.values()
    assert [t.device.type for t in entry.slots] == ["meta", "meta"]
    assert [(t.device.type, t.shape) for t in out] == [("meta", (3,)),
                                                       ("meta", (2,))]


def test_launch_counters_count_replays(stub, monkeypatch):
    """A capture's launches are taken back and added at each replay: the
    counters read the warm-up's launches and one frame's a replay. (The
    counters are the modules' own: set back after the test.)"""
    for _, mod, name in compiled._COUNTERS:
        monkeypatch.setattr(mod, name, 0)
    def fn(x):
        raster.K1_LAUNCHES += 2
        sampling.K7_LAUNCHES += 1
        return x * 2

    cf = compiled.CompiledFn(fn)
    x = torch.ones(3)
    c0 = compiled.launch_counts()
    cf(x)                                     # warm-up + capture + replay
    c1 = compiled.launch_counts()
    assert (c1["K1"] - c0["K1"], c1["K7"] - c0["K7"]) == (4, 2)
    cf(x)
    c2 = compiled.launch_counts()
    assert (c2["K1"] - c1["K1"], c2["K7"] - c1["K7"]) == (2, 1)
    entry, = cf._entries.values()
    assert entry.launches == {**dict.fromkeys(c0, 0), "K1": 2, "K7": 1}


def test_engine_renders_settled_frames_compiled(engine, stub):
    """Settled frames go through ``compiled_frame`` and
    ``compiled_shadow_atlas``, one capture each; every frame equals the
    eager frame on its arguments, across an orbiting camera, a
    ``set_param`` and a repack (an object moved: the new scene and atlas
    reach the frame's graph without a new capture; the atlas re-renders
    through its own)."""
    eng = engine
    tframe.compiled_frame.cache_clear()
    tframe.compiled_shadow_atlas.cache_clear()
    cf, ca = (tframe.compiled_frame(eng.cfg),
              tframe.compiled_shadow_atlas(eng.cfg))
    # the caster nearest the middle (object 1 is the ground slab)
    oid = min((o for o, obj in eng.world.world_objects()
               if o != 1 and obj.get_light() is None),
              key=lambda o: float(np.hypot(
                  *eng.world.get_world_object(o).transform.position[[0, 2]])))
    for i in range(3):
        a = 2.0 * math.pi * i / 3
        eng.camera.position = np.array([12 * math.cos(a), 6.0,
                                        12 * math.sin(a)], np.float32)
        eng.camera.look_at(np.zeros(3, np.float32))
        if i == 1:
            eng.set_param(tframe.PARAM_EXPOSURE, 2.5)
        if i == 2:
            before = eng._atlas
            eng.world.get_world_object_mut(oid).transform.position[0] += 1.5
        out = eng.run_frame(0.0)
        assert eng._settled
        if i == 2:
            atlas = tframe.render_shadow_atlas(eng._pack.scene,
                                               eng._pack.lights, eng.cfg)[0]
            assert torch.equal(eng._atlas, atlas)
            assert not torch.equal(atlas, before)
        _equal(out, tframe.render_frame(*_args(eng), eng.cfg, eng._atlas))
    assert len(cf._entries) == 1 and len(ca._entries) == 1
    assert tframe.compiled_frame(eng.cfg) is cf
    eng.set_param(tframe.PARAM_EXPOSURE, 1.0)


def test_recompile_kernels_drops_the_compiled_frames(engine, monkeypatch):
    eng = engine
    tframe.compiled_frame(eng.cfg)
    tframe.compiled_shadow_atlas(eng.cfg)
    monkeypatch.setattr(eng._reloader, "reload_if_changed",
                        lambda library: treload.ReloadResult())
    eng.recompile_kernels()
    assert tframe.compiled_frame.cache_info().currsize >= 1
    monkeypatch.setattr(eng._reloader, "reload_if_changed",
                        lambda library: treload.ReloadResult(
                            reloaded=[treload.LIBRARY]))
    eng.recompile_kernels()
    assert tframe.compiled_frame.cache_info().currsize == 0
    assert tframe.compiled_shadow_atlas.cache_info().currsize == 0


# ---- the uploads a capture cannot take ---------------------------------------------

@contextlib.contextmanager
def _no_uploads(monkeypatch):
    """``torch.tensor`` and ``Tensor.new_tensor`` (a host-to-device copy
    from pageable memory on the card) raise."""
    def refuse(*a, **k):
        raise AssertionError("an upload inside the frame")
    with monkeypatch.context() as m:
        m.setattr(torch, "tensor", refuse)
        m.setattr(torch.Tensor, "new_tensor", refuse)
        yield


def test_off_chain_pool_samples_without_uploads(monkeypatch):
    """A pool whose levels do not halve (16, 8, 3) looks its levels up in
    tables uploaded once with the pool: bit-equal to the jitted JAX
    sampler, with nothing uploaded."""
    rng = np.random.default_rng(0)
    mips = [rng.uniform(0, 1, (4, s, s, 9)).astype(np.float32)
            for s in (16, 8, 3)]
    j = jsampling.pack_texture_pool(mips, u8=True)
    t = sampling.pool_from_numpy(vars(j), "cpu")
    tex = rng.integers(0, 4, (32, 64)).astype(np.int32)
    uv = rng.uniform(-2, 3, (32, 64, 2)).astype(np.float32)
    lvl = rng.uniform(-0.5, 2.5, (32, 64)).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, a, b, c: jsampling.sample_pool_mip(
        p, a, b, c, filter="bilinear"))(j, tex, uv, lvl))
    t.level_tables                                  # built with the pool
    with _no_uploads(monkeypatch):
        got = sampling.sample_pool_mip(t, torch.from_numpy(tex),
                                       torch.from_numpy(uv),
                                       torch.from_numpy(lvl),
                                       filter="bilinear")
    np.testing.assert_array_equal(got.numpy(), want)


def test_native_pool_without_duv_samples_without_uploads(monkeypatch):
    """The native pool's rebiased scalar level (no ``duv``): within the
    existing test's 5e-7 of the jitted JAX sampler, nothing uploaded."""
    from test_torch_presets import _chains, _native_inputs
    jp = jsampling.pack_native_pool(_chains(), windowed=True)
    tp = sampling.pack_native_pool(_chains(), windowed=True)
    rec, uv, lvl = _native_inputs()
    want = np.asarray(jax.jit(lambda p, r, u, l: jsampling.sample_pool_mip(
        p, r, u, l, filter="dithered"))(jp, rec, uv, lvl))
    sampling._bayer_threshold(lvl.shape, torch.device("cpu"))
    with _no_uploads(monkeypatch):
        got = sampling.sample_pool_mip(tp, torch.from_numpy(rec),
                                       torch.from_numpy(uv),
                                       torch.from_numpy(lvl),
                                       filter="dithered")
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=5e-7)


def test_translate_setup_y_without_uploads(monkeypatch):
    """The band setup folds ``y0`` in as a filled scalar: the parent's
    ``new_tensor`` rows, bbox and screen, bit for bit, nothing uploaded."""
    rng = np.random.default_rng(3)
    T = 257
    setup = raster.TriangleSetup(
        rows=torch.from_numpy(rng.standard_normal((T, 16)).astype(np.float32)),
        valid=torch.from_numpy(rng.uniform(size=T) > 0.2),
        bbox=torch.from_numpy(rng.uniform(-50, 900, (T, 4)).astype(np.float32)),
        screen=torch.from_numpy(rng.uniform(-50, 900, (T, 3, 2))
                                .astype(np.float32)),
        inv_w=torch.ones(T, 3), z_ndc=torch.zeros(T, 3))
    y0 = 270.25
    y = setup.rows.new_tensor(y0)
    rows = setup.rows.clone()
    cols = [x + 2 for x in (raster._E0X, raster._E1X, raster._E2X,
                            raster._ZX)]
    rows[:, cols] = fma(rows[:, [c - 1 for c in cols]], y, rows[:, cols])
    with _no_uploads(monkeypatch):
        got = raster.translate_setup_y(setup, y0)
    assert torch.equal(got.rows, rows)
    assert torch.equal(got.bbox[:, 1::2], setup.bbox[:, 1::2] - y)
    assert torch.equal(got.screen[:, :, 1], setup.screen[:, :, 1] - y)


def test_fidelity_timing_captures_nothing_in_its_timed_rounds(engine, stub,
                                                              monkeypatch):
    """The fidelity report's ``--time`` over more configurations than
    ``compiled_frame``'s cache holds (8): each engine's frame is captured
    once as a body of its own before the timed rounds, and the rounds look
    nothing up in the cache (its misses do not move) and capture nothing
    (every body's graph count stays one). Timing through ``run_frame``
    evicted each configuration before its turn came back and captured it
    again in every round."""
    from tinyrenderer_tpu_torch.tools import fidelity_report, timing
    grid = fidelity_report.configurations(engine.cfg)
    names = ("default", "default_f32_attrs", "default_texscale2",
             "default_trilinear", "default_sky1", "default_sky4",
             "default_shadow4", "default_f32_atlas", "default_skyblk",
             "default_trilinear_sky4")
    assert len({grid[n] for n in names}) == len(names) > 8
    engines = {n: Engine.from_world(demo.build_demo_world(), cfg=grid[n],
                                    device="cpu") for n in names}
    seen = {}
    inner = timing.round_robin

    def round_robin(bodies, rounds, frames, device, log=True):
        seen["bodies"] = bodies
        seen["before"] = tframe.compiled_frame.cache_info().misses
        out = inner(bodies, rounds, frames, device, log)
        seen["after"] = tframe.compiled_frame.cache_info().misses
        return out

    monkeypatch.setattr(timing, "round_robin", round_robin)
    ms = fidelity_report.time_engines(engines, rounds=2, frames=1)
    assert set(ms) == set(names)
    assert all(len(v) == 2 and min(v) > 0 for v in ms.values())
    assert seen["after"] == seen["before"]
    assert all(len(b.fn._entries) == 1 for b in seen["bodies"].values())
    assert all(e._settled for e in engines.values())

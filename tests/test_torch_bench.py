"""The port's benchmark (``tinyrenderer_tpu_torch/bench.py``) against the
repository's ``bench.py`` on the CPU: the same scenes and configs at a
small size, the multi-light and forward-only frames against the JAX
engine's, the percentiles, the golden check through the port, the PNG
reader without PIL, and the timing, raster-stage and editor items on
small frames. Each side builds its worlds from its own package; the port
renders the level that bench.py loaded, if it loaded one."""

import dataclasses
import io
import json
import os
import struct
import zlib

import jax
import numpy as np
import planes
import pytest
import torch
from PIL import Image

import bench as jbench
from tinyrenderer_tpu.config import RenderConfig as JRenderConfig
from tinyrenderer_tpu.ops import raster as jraster
from tinyrenderer_tpu.render import frame as jframe
from tinyrenderer_tpu.render.engine import Engine as JEngine
from tinyrenderer_tpu.scene import demo as jdemo
from tinyrenderer_tpu_torch import bench
from tinyrenderer_tpu_torch.config import RenderConfig
from tinyrenderer_tpu_torch.render import frame as tframe
from tinyrenderer_tpu_torch.render.engine import Engine as TEngine
from tinyrenderer_tpu_torch.scene import demo
from tinyrenderer_tpu_torch.utils import image_io, verify

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
SMALL = dict(width=160, height=96)
# the frames held against the JAX engine: a 64-texel atlas, a 32-texel
# environment cube and the shadow-bin capacity the 25 views grow to keep
# its first frame to one compile
FRAME = dict(SMALL, shadow_size=64, env_size=32, shadow_bin_capacity=512)
# the timed items' frames on the CPU
TINY = dict(width=64, height=48, shadow_size=32, env_size=16,
            irradiance_size=4)
SCENES = {"default": {}, "parity": dict(parity=True),
          "forward": dict(forward=True), "stress": dict(stress=True),
          "highpoly": dict(highpoly=True), "multilight": dict(multilight=True)}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Six test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _objects(world):
    return (len(list(world.world_objects())),
            len(list(world.omnipresent_objects())))


def _jax_build(**kw):
    """bench.py's ``build_engine(**kw)`` and the level it loaded (None for
    the demo world): bench.py takes the reference's test.lvl where that
    exists."""
    loaded = []
    load = JEngine.load_level

    def spy(self, path):
        loaded.append(path)
        return load(self, path)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JEngine, "load_level", spy)
        je = jbench.build_engine(**kw)
    return je, (loaded[0] if loaded else None)


def _both(cfg_overrides, **flags):
    """bench.py's engine and the port's, on the same scene."""
    je, level = _jax_build(cfg_overrides=cfg_overrides, **flags)
    te = bench.build_engine(cfg_overrides=cfg_overrides, device="cpu",
                            level=level, **flags)
    return je, te


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_build_engine_matches_bench_py(scene):
    """Each scene and config of bench.py's ``build_engine`` at 160x96
    through ``cfg_overrides``: after ``update`` the RenderConfig fields,
    the objects, the lights and the parameters are equal; config 2 has 25
    shadow views."""
    flags = SCENES[scene]
    je, te = _both(SMALL, **flags)
    je.update(0.0)
    te.update(0.0)
    assert dataclasses.asdict(te.cfg) == dataclasses.asdict(je.cfg)
    assert _objects(te.world) == _objects(je.world)
    assert te._pack.counts == dict(je._pack.counts)
    np.testing.assert_array_equal(te.params.numpy(), np.asarray(je.params))
    if scene == "multilight":
        assert (te.cfg.num_point_lights, te.cfg.num_directional_lights) == (4, 1)
        assert te.cfg.num_shadow_views == 25
    if scene == "forward":
        assert te.cfg.forward_only and not te.cfg.enable_shadows
        assert not te.cfg.enable_ibl
    if scene == "stress":
        assert float(te.params[tframe.PARAM_SHADOW_BIAS]) == pytest.approx(2e-3)


def test_build_engine_takes_the_level_it_is_given():
    """The level branches render the level they are given (demo.lvl
    stands in for test.lvl): the multi-light scene tops its point lights
    up to four with the same seeded positions as bench.py."""
    level = os.path.join(bench.ROOT, "levels", "demo.lvl")
    for flags in ({}, dict(forward=True), dict(multilight=True)):
        eng = bench.build_engine(cfg_overrides=SMALL, device="cpu",
                                 level=level, **flags)
        lvl = TEngine(cfg=RenderConfig(**SMALL), device="cpu",
                      level_path=level)
        n_lvl = _objects(lvl.world)[0]
        extra = 3 if flags.get("multilight") else 0   # demo.lvl has one
        assert _objects(eng.world)[0] == n_lvl + extra, flags
        np.testing.assert_array_equal(eng.camera.to_raw(),
                                      lvl.camera.to_raw())
    eng.update(0.0)
    assert eng.cfg.num_point_lights == 4
    assert bench.scene_label(level) == "demo.lvl"
    assert bench.scene_label(None) == "demo world, no-level"


def _frames_against_jax(flags, cfg_overrides=FRAME):
    """The scene's first frame on each side at FRAME's size."""
    je, te = _both(cfg_overrides, **flags)
    return je, je.run_frame(0.0), te, te.run_frame(0.0)


def _assert_frames_equal(je, j_out, te, t_out):
    """Under the JAX package's rounding of the raster planes
    (tests/planes.py) the port's frame equals the JAX frame as before; the
    port's own frame ``t_out`` is held to it by ``planes.hold_frame`` (no
    farther from the float64 planes' frame than the JAX frame, the
    edge-aware comparator)."""
    under_jax, f64 = planes.beside(lambda: planes.rerun(te))
    planes.hold_frame(t_out, j_out, f64)
    t_out = under_jax
    assert dataclasses.asdict(te.cfg) == dataclasses.asdict(je.cfg)
    jp = np.asarray(j_out.pick_id)
    assert t_out.pick_id.shape == jp.shape == (FRAME["height"],
                                               FRAME["width"])
    np.testing.assert_array_equal(t_out.pick_id.numpy(), jp)
    np.testing.assert_array_equal(t_out.depth.numpy(), np.asarray(j_out.depth))
    res = verify.edge_aware_compare(t_out.sdr.numpy(), np.asarray(j_out.sdr),
                                    pick=jp)
    assert res["status"] == "pass", res
    assert len(np.unique(jp)) > 20 and (jp == 0).any()


def test_multilight_frame_matches_jax_engine():
    """BASELINE config 2 (4 point + 1 directional light: 25 shadow views,
    four billboards through the overlay) at 160x96 with a 64-texel atlas:
    the port's engine frame against the JAX engine's."""
    je, j_out, te, t_out = _frames_against_jax(dict(multilight=True))
    assert te.cfg.num_shadow_views == 25 and te.cfg.has_forward
    assert tframe.use_fused_shading(te.cfg)
    _assert_frames_equal(je, j_out, te, t_out)


def test_forward_config_frame_matches_jax_engine():
    """BASELINE config 1's flags (forward-only, shadows, IBL and SSR off)
    at 160x96: the port's engine frame against the JAX engine's."""
    je, j_out, te, t_out = _frames_against_jax(dict(forward=True))
    assert te.cfg.forward_only and not te.cfg.enable_shadows
    _assert_frames_equal(je, j_out, te, t_out)


def test_stress_frame_matches_jax_engine():
    """BASELINE config 5 (the 500-object stress world, 8x8 gate blocks,
    shadow bias 2e-3) at 160x96 with a 64-texel atlas: the port's engine
    frame against the JAX engine's, at the bin capacities its first frame
    grows to (one render a side)."""
    je, j_out, te, t_out = _frames_against_jax(
        dict(stress=True), dict(FRAME, bin_capacity=1024,
                                shadow_bin_capacity=4096))
    assert te.cfg.gate_block_h == te.cfg.gate_block_w == 8
    assert te._pack.counts["instances"] > 500 and te.frame_index == 1
    _assert_frames_equal(je, j_out, te, t_out)


def test_percentiles_equal_bench_py():
    rng = np.random.default_rng(3)
    for n in (1, 2, 3, 7, 16, 33, 64, 128):
        times = list(rng.exponential(5.0, n))
        assert bench.percentiles(times) == jbench.percentiles(times), n


def test_verify_goldens_through_the_port():
    """bench.py's golden cases through the port on the CPU (the kernels'
    plain versions, ``use_pallas=True``) at bench.py's configs and bars:
    the four scenes the repository holds pass; the two on test.lvl report
    ``no-level`` without a level."""
    res = bench.verify_goldens(device="cpu")
    assert list(res) == ["demo", "demo_textured", "test_lvl", "demo_fused",
                         "demo_bf16", "default"]
    for case in ("demo", "demo_textured", "demo_fused", "demo_bf16"):
        assert res[case]["status"] == "pass", (case, res[case])
    assert res["test_lvl"]["status"] == res["default"]["status"] == "no-level"
    skipped = bench.verify_goldens(device="cpu", budget_cases=10,
                                   remaining=lambda: 5.0)
    assert all(v["skipped"] == "budget" for v in skipped.values())


def _png_with_filters(img: np.ndarray, filters) -> bytes:
    """PNG bytes of ``img`` whose scanline y uses ``filters[y % len]``,
    filtered as the PNG specification's section 9 says."""
    h, w, c = img.shape
    a = img.reshape(h, w * c).astype(np.int64)
    rows = []
    for y in range(h):
        f = filters[y % len(filters)]
        up = a[y - 1] if y else np.zeros(w * c, np.int64)
        left = np.concatenate([np.zeros(c, np.int64), a[y, :-c]])
        corner = np.concatenate([np.zeros(c, np.int64), up[:-c]])
        if f == 0:
            pred = np.zeros(w * c, np.int64)
        elif f == 1:
            pred = left
        elif f == 2:
            pred = up
        elif f == 3:
            pred = (left + up) // 2
        else:
            p = left + up - corner
            pa, pb, pc = abs(p - left), abs(p - up), abs(p - corner)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, up, corner))
        rows.append(bytes([f]) + ((a[y] - pred) % 256).astype(np.uint8)
                    .tobytes())

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data)))
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 6 if c == 4 else 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + chunk(b"IEND", b""))


def test_load_png_equals_pil():
    """``image_io.load_png`` reads every golden PNG (filters 1, 2 and 4)
    as PIL does; it reads frames of every filter type, each on its own and
    mixed, RGB and RGBA, and the port's encoders' output, equal to the
    image."""
    names = sorted(n for n in os.listdir(GOLDEN_DIR) if n.endswith(".png"))
    assert len(names) >= 4
    for n in names:
        path = os.path.join(GOLDEN_DIR, n)
        np.testing.assert_array_equal(image_io.load_png(path),
                                      np.asarray(Image.open(path)), n)
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (23, 31, 4), dtype=np.uint8)
    img[8:14] = img[8:14] // 16 * 16           # smooth rows
    for c in (3, 4):
        im = np.ascontiguousarray(img[..., :c])
        for filters in ([0], [1], [2], [3], [4], [0, 1, 2, 3, 4]):
            out = image_io.decode_png(_png_with_filters(im, filters))
            np.testing.assert_array_equal(out, im, (c, filters))
        buf = io.BytesIO()
        Image.fromarray(im).save(buf, "PNG", optimize=True)
        np.testing.assert_array_equal(image_io.decode_png(buf.getvalue()), im)
        for png in (image_io.encode_png(im), image_io._encode_png_zlib(im)):
            np.testing.assert_array_equal(image_io.decode_png(png), im)
    with pytest.raises(ValueError):
        image_io.decode_png(b"not a png")


def test_run_config_times_a_settled_engine(tmp_path):
    """``run_config`` on the CPU at 64x48: the line's keys, ITERS x REPS
    frame spans, the loop-doubling check, a profiler trace, no move."""
    res = bench.run_config("forward", "m", reps=2, iters=3, scale_check=True,
                           trace_dir=str(tmp_path), device="cpu",
                           forward=True, cfg_overrides=TINY)
    assert "error" not in res, res
    ex = res["extra"]
    assert res["value"] == ex["p50_ms"] > 0 and ex["reps"] == 6
    assert ex["device"].startswith("cpu: ")
    assert set(ex) >= {"p10_ms", "p90_ms", "min_ms", "loop_mean_ms",
                       "triangles", "shadow_views", "shadow_atlas_ms",
                       "capture_ms", "atlas_capture_ms", "peak_mib",
                       "config_moved", "loop_scaling_ok"}
    assert ex["config_moved"] is False and isinstance(ex["loop_scaling_ok"],
                                                      bool)
    assert ex["capture_ms"] is None      # the CPU captures no graph
    assert os.path.getsize(tmp_path / "frame_trace.json") > 0
    # a world with one shadow view: the compiled atlas is timed too
    eng = TEngine.from_world(
        demo.build_demo_world(n_cubes=4, with_point_light=False),
        camera=demo.build_demo_camera(64, 48),
        cfg=RenderConfig(**TINY), device="cpu")
    t = bench.time_engine(eng, reps=1, iters=2)
    assert t.atlas_ms > 0 and len(t.frame_ms) == 2 and t.loop_ms[0] > 0
    bad = bench.run_config("x", "m", device="cpu",
                           cfg_overrides=dict(no_such_field=1))
    assert bad["value"] is None and "no_such_field" in bad["error"]


def test_time_engine_times_again_when_the_config_moved(monkeypatch):
    """A capacity set far over its need shrinks after SHRINK_AFTER steady
    frames inside a timed window: the configuration is settled and timed
    once more, and ``config_moved`` says what moved."""
    monkeypatch.setattr(TEngine, "SHRINK_AFTER", 4)
    eng = bench.build_engine(forward=True, device="cpu",
                             cfg_overrides=dict(TINY, bin_capacity=4096))
    t = bench.time_engine(eng, reps=2, iters=3)
    assert t.config_moved and t.moved_fields["first"]["bin_capacity"][0] == 4096
    assert "again" not in t.moved_fields and len(t.frame_ms) == 6
    assert eng.cfg.bin_capacity < 4096


def _jax_raster_stage(je):
    """bench.py's raster stage (its ``raster_loop`` step) once, jitted."""
    cfgc = je.cfg
    pw, ph = cfgc.padded_width, cfgc.padded_height

    @jax.jit
    def stage(scene, cam):
        camd = jframe._unpack_camera(cam)
        _w, clip, _a = jframe.geometry_stage(scene, camd["view_proj"])
        setup = jraster.triangle_setup(clip, scene.tri_vidx,
                                       scene.tri_deferred, pw, ph, "back")
        sbins = jraster.bin_triangles_stream(
            setup, pw, ph, cfgc.tile_h, cfgc.tile_w, cfgc.stream_capacity,
            cfgc.bin_big_capacity)
        ty, tx = sbins.counts.shape
        return jraster.rasterize_stream(sbins, ty, tx, cfgc.tile_h,
                                        cfgc.tile_w, kmax=cfgc.bin_capacity)
    return stage(je._pack.scene, je.camera.to_raw())


def test_raster_stage_matches_bench_py():
    """The raster stage that ``measure_raster_throughput`` times (vertex
    transform, setup, CSR stream binning, K4's plain version) on one
    high-poly sphere at 256x128 under bench.py's 8x128 tiles: triangle ids
    and depth bit-equal to bench.py's jitted stage."""
    cfg = RenderConfig(width=256, height=128, tile_h=8, tile_w=128,
                       bin_capacity=1024, max_vertices=16384,
                       max_triangles=16384)
    je = JEngine.from_world(jdemo.build_highpoly_world(1),
                            camera=jdemo.build_demo_camera(256, 128),
                            cfg=JRenderConfig(**dataclasses.asdict(cfg)))
    te = TEngine.from_world(demo.build_highpoly_world(1),
                            camera=demo.build_demo_camera(256, 128), cfg=cfg,
                            device="cpu")
    for eng in (je, te):       # close by, as tests/test_torch_highpoly.py
        eng.camera.position = np.array([-3.0, 2.5, 0.0], np.float32)
        eng.camera.look_at(np.zeros(3, np.float32))
        eng.update(0.0)
    assert te._pack.counts["triangles"] > 4096
    stage = bench.raster_stage(te.cfg)
    under_jax, (tid, depth), f64 = planes.three(lambda: stage(
        te._pack.scene, torch.as_tensor(te.camera.to_raw())))
    jtid, jdepth = _jax_raster_stage(je)
    assert (tid >= 0).sum() > 2000
    # the parity decision (tests/planes.py): bit-equal under the JAX
    # package's rounding of the planes; the port's own ids and depth held
    # to the float64 planes' and no farther from them than the JAX stage's
    np.testing.assert_array_equal(under_jax[0].numpy(), np.asarray(jtid))
    np.testing.assert_array_equal(under_jax[1].numpy(), np.asarray(jdepth))
    planes.assert_nearer({"pick_id": tid, "depth": depth},
                         {"pick_id": jtid, "depth": jdepth},
                         {"pick_id": f64[0], "depth": f64[1]})


def test_editor_roundtrip_on_a_small_frame():
    """BASELINE config 4: ``build_engine(editor=True)`` is bench.py's
    editor engine (the demo world of 16 cubes at 800x600); its round trip
    at 64x48 (shadows off: an edit frame re-renders the atlas, seven views
    on the CPU): 50 add/deletes, the pick and gizmo drag, the level saved
    and read back equal."""
    eng = bench.build_engine(editor=True, device="cpu")
    assert (eng.cfg.width, eng.cfg.height) == (800, 600)
    assert _objects(eng.world) == _objects(jdemo.build_demo_world(n_cubes=16))
    res = bench.measure_editor_roundtrip(bench.build_engine(
        editor=True, device="cpu",
        cfg_overrides=dict(TINY, enable_shadows=False)))
    assert res["lvl_roundtrip"] is True
    assert res["edit_ms_per_frame"] > 0 and res["pick_gizmo_ms_per_frame"] > 0


def test_cpu_ratio_reads_its_cache(tmp_path, monkeypatch):
    """The CPU ratio divides the cached CPU frame by the card's, and
    without a cache of the same scene reports bench.py's error instead of
    measuring."""
    path = tmp_path / "cpu_raster_cache.json"
    monkeypatch.setattr(bench, "CPU_CACHE_PATH", str(path))
    res = bench.measure_cpu_raster_ratio(5.0, allow_measure=False)
    assert "no CPU cache" in res["error"] and "speedup_vs_cpu" not in res
    path.write_text(json.dumps({"cpu_softraster_ms": 1000.0,
                                "measured_at": "2026-01-01", "cpu": "x"}))
    res = bench.measure_cpu_raster_ratio(5.0, allow_measure=False)
    assert "no CPU cache" in res["error"]      # a cache without its scene
    path.write_text(json.dumps({"cpu_softraster_ms": 1000.0,
                                "scene": "demo world, no-level",
                                "measured_at": "2026-01-01", "cpu": "x"}))
    res = bench.measure_cpu_raster_ratio(5.0, allow_measure=False)
    assert res["speedup_vs_cpu"] == 200.0 and res["cpu_ms_cached"] is True
    res = bench.measure_cpu_raster_ratio(5.0, allow_measure=False,
                                         level="levels/demo.lvl")
    assert "no CPU cache of the demo.lvl" in res["error"]


def test_fidelity_without_a_level_reports_its_error():
    """bench.py's fidelity item reports an error where test.lvl is
    missing; the port's does without a level and renders nothing."""
    res = bench.measure_fidelity(None, device="cpu")
    assert "--level" in res["error"] and "psnr_db_vs_parity" not in res


def test_committed_cpu_cache_is_the_ports_own():
    """The committed CPU frame is this port's, with its CPU named, never
    the JAX package's cache."""
    with open(bench.CPU_CACHE_PATH) as f:
        port = json.load(f)
    with open(jbench.CPU_CACHE_PATH) as f:
        jax_cache = json.load(f)
    assert port["cpu_softraster_ms"] > 0 and port["cpu"]
    assert port["scene"] == bench.scene_label(None)
    assert port["cpu_softraster_ms"] != jax_cache["cpu_softraster_ms"]


def test_main_prints_one_line(capsys):
    """``main`` (``--verify-only`` on the CPU) prints exactly one JSON line
    and leaves the process's signal handlers as it found them."""
    import signal
    before = signal.getsignal(signal.SIGTERM)
    rc = bench.main(["--device", "cpu", "--verify-only"])
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln]
    assert rc == 0 and len(lines) == 1
    res = json.loads(lines[0])
    assert res["value"] == 1 and res["extra"]["device"].startswith("cpu")
    assert res["tpu_golden"]["demo"]["status"] == "pass"
    assert signal.getsignal(signal.SIGTERM) is before

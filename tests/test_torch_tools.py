"""The port's measurement tools (``tinyrenderer_tpu_torch/tools/``: the
stage ledgers, the op ranking, the frame A/B and the op studies) against
the repository's ``tools/`` on the CPU: each prefix of the stage ledgers
against the JAX prefix sequence the reference tool builds (Pallas kernels
in interpret mode), the variant groups against the reference tool's read
from its source, the op studies' forms against each other and the JAX
functions, and the harness, parsers and CLIs at small sizes."""

import ast
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import planes
import pytest
import torch

from tinyrenderer_tpu.config import RenderConfig as JRenderConfig
from tinyrenderer_tpu.ops import raster as jraster
from tinyrenderer_tpu.ops import resolve as jresolve
from tinyrenderer_tpu.ops import sampling as jsampling
from tinyrenderer_tpu.render import frame as jframe
from tinyrenderer_tpu.render.engine import Engine as JEngine
from tinyrenderer_tpu.scene import demo as jdemo
from tinyrenderer_tpu.scene.camera import Camera as JCamera
from tinyrenderer_tpu_torch import bench
from tinyrenderer_tpu_torch.config import RenderConfig
from tinyrenderer_tpu_torch.ops import raster as traster
from tinyrenderer_tpu_torch.ops import resolve as tresolve
from tinyrenderer_tpu_torch.render import compiled
from tinyrenderer_tpu_torch.render.engine import Engine as TEngine
from tinyrenderer_tpu_torch.scene import demo
from tinyrenderer_tpu_torch.tools import (ab_frame, bench_binning,
                                          bench_gather_pcf, bench_sky_blocks,
                                          bench_stages, dump_graph,
                                          profile_frame, profile_highpoly,
                                          timing, trace_top)
from tinyrenderer_tpu_torch.utils import verify

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the demo world at 128x64: one 64x128 tile, a 64-texel atlas
SMALL = dict(width=128, height=64, shadow_size=64, env_size=16,
             irradiance_size=4)
# 401 cubes (4812 triangles: the stream path) at 128x64 under 8x128 tiles
STREAM = dict(width=128, height=64, tile_h=8, tile_w=128, shadow_size=64,
              shadow_tile=64, env_size=16, irradiance_size=4,
              bin_big_capacity=256, shadow_bin_capacity=4096)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Six test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _cam(eng):
    return jnp.asarray(eng.camera.to_raw())


def _pair(world, cfg_kw):
    """The port's engine on ``world(demo)`` settled as the tool settles it,
    and the JAX engine of the same world packed under its config."""
    te = TEngine.from_world(world(demo),
                            camera=demo.build_demo_camera(cfg_kw["width"],
                                                          cfg_kw["height"]),
                            cfg=RenderConfig(**cfg_kw), device="cpu")
    bench.settle(te)
    je = JEngine.from_world(world(jdemo),
                            camera=jdemo.build_demo_camera(te.cfg.width,
                                                           te.cfg.height),
                            cfg=JRenderConfig(**dataclasses.asdict(te.cfg)))
    je.update(0.0)
    assert dataclasses.asdict(je.cfg) == dataclasses.asdict(te.cfg)
    return te, je


@pytest.fixture(scope="module")
def demo_pair():
    return _pair(lambda d: d.build_demo_world(n_cubes=50), SMALL)


@pytest.fixture(scope="module")
def stream_pair():
    return _pair(lambda d: d.build_demo_world(n_cubes=400,
                                              with_point_light=False), STREAM)


def _jax_atlas(je):
    return jframe.compiled_shadow_atlas(je.cfg)(je._pack.scene,
                                                je._pack.lights)[0]


def _jax_full(je, atlas):
    """The reference tools' full row: the frame on the settled atlas."""
    cfg = je.cfg
    return jframe.compiled_frame(cfg)(
        je._pack.scene, je._packer.pool_for(cfg), je._pack.lights, _cam(je),
        je.params, je._ensure_env(), atlas)


def _jax_stages(je):
    """``tools/bench_stages.py:68-105``'s prefix sequence on ``je``, jitted
    once: every stage's outputs."""
    cfg = je.cfg
    scene = je._pack.scene
    pool = je._packer.pool_for(cfg)
    PW, PH = cfg.padded_width, cfg.padded_height

    @jax.jit
    def stages(cam):
        c = jframe._unpack_camera(cam)
        world, clip, attrs = jframe.geometry_stage(scene, c["view_proj"])
        setup = jraster.triangle_setup(clip, scene.tri_vidx,
                                       scene.tri_deferred, PW, PH, "back")
        bins = jraster.bin_triangles(setup, PW, PH, cfg.tile_h, cfg.tile_w,
                                     cfg.bin_capacity, cfg.bin_big_capacity)
        tri_id, depth = jraster.rasterize_binned(
            bins, cfg.tile_h, cfg.tile_w, use_pallas=True)
        table = jresolve.build_gbuffer_table(
            setup, scene.tri_vidx, attrs, scene.tri_instance,
            scene.inst_object_id, scene.inst_material, scene.mat_record,
            scene.mat_flat)
        r = jresolve.resolve_attrs_pallas(tri_id, bins.ids, table,
                                          cfg.tile_h, cfg.tile_w,
                                          counts=bins.counts)
        g, tex_needed = jresolve.resolve_gbuffer_from_attrs(
            r, tri_id, depth, pool, texture_filter=cfg.texture_filter,
            texture_scale=cfg.texture_scale,
            tex_block_capacity=cfg.tex_block_capacity)
        return dict(clip=clip, rows=setup.rows, bins=bins, tri_id=tri_id,
                    depth=depth, table=table, r=r, g=g, tex_needed=tex_needed)
    return stages(_cam(je))


def _assert_table(t, j):
    """Each triangle's row of the resolve table within 4e-6 of the row's
    largest magnitude (the port and XLA round its plane terms in different
    orders; 1.6e-6 is the largest seen on these scenes)."""
    j = np.asarray(j)
    bar = 4e-6 * np.abs(j).max(axis=1, keepdims=True)
    assert (np.abs(_np(t).astype(np.float64) - j) <= bar).all()


def _assert_fields(t: dict, j, rel: float, frac: float = 0.0):
    """Integer and boolean fields equal; float fields within ``rel`` of
    the field's largest magnitude on all but ``frac`` of their elements."""
    for f, v in t.items():
        b = np.asarray(getattr(j, f))
        a = _np(v)
        if not v.is_floating_point():
            np.testing.assert_array_equal(a, b, err_msg=f)
            continue
        off = np.abs(a.astype(np.float64) - b) > rel * np.abs(b).max()
        assert off.mean() <= frac, (f, off.mean(), np.abs(a - b).max())


def _hold_planes(raster, full, j, jfull, raster64, full64):
    """The parity decision (tests/planes.py): the port's own raster stage
    and frame against the JAX package's and the float64 planes' ones
    (``planes.assert_nearer``); the port's own frame through the
    edge-aware comparator against both."""
    planes.assert_nearer(
        {"pick_id": raster["tri_id"], "depth": raster["depth"]},
        {"pick_id": j["tri_id"], "depth": j["depth"]},
        {"pick_id": raster64["tri_id"], "depth": raster64["depth"]})
    names = ("pick_id", "depth", "sdr")
    own, f64 = ({k: d[k] for k in names} for d in (full, full64))
    jax = planes.frame_fields(jfull, names)
    planes.assert_nearer(own, jax, f64)
    planes.assert_sdr(own["sdr"], jax, f64)


def _assert_frame(t, j):
    jp = np.asarray(j.pick_id)
    assert (_np(t["pick_id"]) != jp).mean() <= 1e-3
    assert (_np(t["depth"]) != np.asarray(j.depth)).mean() <= 1e-3
    res = verify.edge_aware_compare(_np(t["sdr"]), np.asarray(j.sdr), pick=jp)
    assert res["status"] == "pass", res
    assert len(np.unique(jp)) > 2 and (jp == 0).any()


def test_bench_stages_prefixes_match_the_reference_sequence(demo_pair):
    """Each prefix of ``bench_stages.stage_fns`` on the 128x64 demo world
    against the JAX prefix sequence of ``tools/bench_stages.py``: setup
    rows, bins, triangle ids and depth bit-equal; the resolve table within
    4e-6 of each row's largest magnitude and K2's float32 planes on JAX's
    table bit-equal (as ``tests/test_torch_resolve.py`` holds K2); the
    resolved attributes and the G-buffer, each from its own package's
    table, within 1e-5 of each field's largest magnitude (the table's
    rounding through the perspective divide), their integer fields equal;
    the full frame through ``edge_aware_compare``."""
    te, je = demo_pair
    fns = bench_stages.stage_fns(te)
    assert tuple(fns) == bench_stages.STAGES
    cam = timing.camera(te)
    j = _jax_stages(je)
    # the checks below hold the stages under the JAX package's rounding of
    # the raster planes; the port's own raster and frame are held under
    # the parity decision (``_hold_planes``)
    out, port, f64 = planes.three(lambda: {s: fn(cam) for s, fn in fns.items()})
    jfull = _jax_full(je, _jax_atlas(je))
    _hold_planes(port["raster"], port["full"], j, jfull, f64["raster"],
                 f64["full"])
    assert torch.equal(out["null"]["camera"], cam)
    np.testing.assert_array_equal(_np(out["geometry"]["clip"]), j["clip"])
    np.testing.assert_array_equal(_np(out["setup"]["rows"]), j["rows"])
    for f in ("ids", "counts", "rows"):
        np.testing.assert_array_equal(_np(out["bin"][f]),
                                      np.asarray(getattr(j["bins"], f)), f)
    for f in ("tri_id", "depth"):
        np.testing.assert_array_equal(_np(out["raster"][f]), j[f], f)
    assert (j["tri_id"] >= 0).mean() > 0.2
    _assert_table(out["select"].pop("table"), j["table"])
    same = tresolve.resolve_attrs_pallas(
        torch.from_numpy(np.array(j["tri_id"])),
        torch.from_numpy(np.array(j["table"])))
    _assert_fields(bench_stages.as_dict(same), j["r"], rel=0)
    _assert_fields(out["select"], j["r"], rel=1e-5)
    mat = out["material"]
    assert int(mat.pop("tex_needed")) == int(j["tex_needed"])
    _assert_fields(mat, j["g"], rel=1e-5)
    _assert_frame(out["full"], jfull)


def test_profile_highpoly_prefixes_match_the_reference_sequence(stream_pair):
    """``profile_highpoly.stage_fns`` on 401 cubes (4812 triangles, the
    stream path) at 128x64 against ``tools/profile_highpoly.py``'s prefix
    sequence: setup rows, the stream bins and K4's ids and depth
    bit-equal; the table within 4e-6 of each row's largest magnitude;
    K5's resolve on JAX's table bit-equal, and from the port's own table
    within 1e-5 of each field's largest magnitude on all but 0.1% of its
    elements (a table's rounding flips a bf16 plane on a few pixels); the
    full frame through ``edge_aware_compare``."""
    te, je = stream_pair
    cfg = je.cfg
    assert jraster.stream_pays_off(je._pack.scene.tri_vidx.shape[0])
    assert te._pack.counts["triangles"] > 4096
    scene = je._pack.scene
    PW, PH = cfg.padded_width, cfg.padded_height
    slim = not cfg.any_textured

    @jax.jit
    def stages(cam):
        camd = jframe._unpack_camera(cam)
        world, clip, attrs = jframe.geometry_stage(scene, camd["view_proj"])
        setup = jraster.triangle_setup(clip, scene.tri_vidx,
                                       scene.tri_deferred, PW, PH, "back")
        sbins = jraster.bin_triangles_stream(
            setup, PW, PH, cfg.tile_h, cfg.tile_w, cfg.stream_capacity,
            cfg.bin_big_capacity)
        ty, tx = sbins.counts.shape
        tri_id, depth = jraster.rasterize_stream(
            sbins, ty, tx, cfg.tile_h, cfg.tile_w, kmax=cfg.bin_capacity)
        table = jresolve.build_gbuffer_table(
            setup, scene.tri_vidx, attrs, scene.tri_instance,
            scene.inst_object_id, scene.inst_material, scene.mat_record,
            scene.mat_flat, slim=slim)
        r = jresolve.resolve_attrs_stream(
            tri_id, sbins, table, cfg.tile_h, cfg.tile_w,
            kmax=cfg.bin_capacity, bf16=cfg.bf16_attrs, slim=slim)
        return dict(world=world, clip=clip, rows=setup.rows, sbins=sbins,
                    tri_id=tri_id, depth=depth, table=table, r=r)
    j = stages(_cam(je))
    fns = profile_highpoly.stage_fns(te)
    assert tuple(fns) == profile_highpoly.STAGES
    cam = timing.camera(te)
    # as the demo world's stages: the checks below under the JAX package's
    # rounding of the planes, the port's own under ``_hold_planes``
    out, port, f64 = planes.three(lambda: {s: fn(cam) for s, fn in fns.items()})
    jfull = _jax_full(je, _jax_atlas(je))
    _hold_planes(port["+raster"], port["full_frame"], j, jfull,
                 f64["+raster"], f64["full_frame"])
    for f in ("world", "clip"):
        np.testing.assert_array_equal(_np(out["geometry"][f]), j[f], f)
    np.testing.assert_array_equal(_np(out["+setup"]["rows"]), j["rows"])
    for f in ("ids", "starts", "counts", "rows"):
        np.testing.assert_array_equal(_np(out["+stream_bin"][f]),
                                      np.asarray(getattr(j["sbins"], f)), f)
    for f in ("tri_id", "depth"):
        np.testing.assert_array_equal(_np(out["+raster"][f]), j[f], f)
    assert (j["tri_id"] >= 0).mean() > 0.2
    _assert_table(out["+table"]["table"], j["table"])
    jbins = traster.StreamBins(**{
        f.name: torch.from_numpy(np.array(getattr(j["sbins"], f.name)))
        for f in dataclasses.fields(traster.StreamBins)})
    same = tresolve.resolve_attrs_stream(
        torch.from_numpy(np.array(j["tri_id"])), jbins,
        torch.from_numpy(np.array(j["table"])), cfg.tile_h, cfg.tile_w,
        cfg.bin_capacity, bf16=cfg.bf16_attrs)
    _assert_fields(bench_stages.as_dict(same), j["r"], rel=0)
    _assert_fields(out["+resolve"], j["r"], rel=1e-5, frac=1e-3)
    _assert_frame(out["full_frame"], jfull)


def test_stage_ledger_and_a_profile_group_on_the_cpu_clock(demo_pair,
                                                           monkeypatch):
    """``stage_ledger`` and the ``gatemin`` group at one round of one
    frame: a row per stage (deltas of consecutive medians) and per
    variant, timed by the host clock. Each variant's module flag holds
    whenever its frame's Python runs (on the CPU, every call; on the card,
    its capture) and is restored after; the stream group's setup forces
    the stream raster only while it is open."""
    te, _ = demo_pair
    rows = bench_stages.stage_ledger(te, rounds=1, frames=1)
    assert [r["stage"] for r in rows] == list(bench_stages.STAGES)
    assert all(r["median_ms"] > 0 for r in rows)
    assert rows[0]["delta_ms"] == rows[0]["median_ms"]
    for a, b in zip(rows, rows[1:]):
        assert b["delta_ms"] == pytest.approx(b["median_ms"] - a["median_ms"])
    from tinyrenderer_tpu_torch.ops import raster, shadows
    monkeypatch.setattr(bench, "settle", lambda eng: None)   # settled
    seen = []
    real = shadows.gate_fns

    def spy(*a, **kw):
        seen.append((shadows._GATE_VIA_MIN, raster.stream_pays_off(1)))
        return real(*a, **kw)
    monkeypatch.setattr(shadows, "gate_fns", spy)
    rows = profile_frame.profile_group(te, "gatemin", rounds=1, frames=1)
    assert [(r["group"], r["variant"]) for r in rows] == [
        ("gatemin", "min-map"), ("gatemin", "pcf-win")]
    assert all(r["median_ms"] > 0 and r["peak_mib"] is None for r in rows)
    assert set(seen) == {(True, False), (False, False)}
    assert shadows._GATE_VIA_MIN == "auto"
    with profile_frame.variant_setup("stream", profile_frame.BASE)():
        assert raster.stream_pays_off(1)
    assert not raster.stream_pays_off(1)


def _reference_groups() -> dict:
    """``tools/profile_frame.py``'s ``groups`` read from its syntax tree:
    {group: {variant: (preset, overrides, flag)}}."""
    with open(os.path.join(ROOT, "tools", "profile_frame.py")) as f:
        tree = ast.parse(f.read())
    node = next(n.value for n in ast.walk(tree) if isinstance(n, ast.Assign)
                and any(isinstance(t, ast.Name) and t.id == "groups"
                        for t in n.targets))
    flags = {"_gate_min": "_GATE_VIA_MIN", "_mxu_planes": "_PLANES_ON_MXU",
             "_flat_blend": "_FLAT_WINDOW_BLEND",
             "_pallas_blend": "_WINDOWED_BLEND_PALLAS"}

    def config(v):
        if isinstance(v, ast.Name):                       # base
            return (None, {})
        if isinstance(v.func, ast.Attribute):             # base.preset()
            return (v.func.attr, {})
        inner = config(v.args[0])                         # replace(x, **kw)
        return (inner[0], {k.arg: ast.literal_eval(k.value)
                           for k in v.keywords})

    out = {}
    for gk, gv in zip(node.keys, node.values):
        group = {}
        for vk, vv in zip(gv.keys, gv.values):
            flag = None
            if isinstance(vv, ast.Tuple):                 # (cfg, setup)
                call = vv.elts[1]
                flag = (flags[call.func.id],
                        ast.literal_eval(call.args[0]))
                vv = vv.elts[0]
            group[ast.literal_eval(vk)] = (*config(vv), flag)
        out[ast.literal_eval(gk)] = group
    return out


def test_profile_frame_groups_are_the_reference_tools():
    """The groups, their variants and each variant's ``replace(...)``
    overrides, preset and module flag equal the reference tool's, less
    ``wblend`` and ``rkernel``, which raise naming the decision (and exit
    non-zero from the CLI)."""
    ref = _reference_groups()
    assert set(ref) == set(profile_frame.GROUPS) | set(profile_frame.LEFT_OUT)
    for g, variants in profile_frame.GROUPS.items():
        assert list(variants) == list(ref[g]), g
        for name, v in variants.items():
            flag = (v.flag[1], v.flag[2]) if v.flag else None
            assert (v.preset, dict(v.overrides), flag) == ref[g][name], (g,
                                                                         name)
    for g in profile_frame.LEFT_OUT:
        with pytest.raises(profile_frame.LeftOutByDecision,
                           match="Left out by decision"):
            profile_frame.group(g)
        with pytest.raises(SystemExit, match="Left out by decision"):
            profile_frame.main(["--device", "cpu", "--set", g])
    base = RenderConfig()
    v = profile_frame.GROUPS["layout"]["preset-75"]
    assert v.config(base) == dataclasses.replace(base.performance_preset(),
                                                 render_scale_pct=75)


def test_ab_frame_flags_and_config_pair(demo_pair):
    """``--flag`` takes the port's ``_GATE_VIA_MIN`` and refuses the
    reference's other module flags and other modules, naming the decision,
    and times the frame with it False and True; ``--cfg`` parses typed
    overrides and times two settled engines."""
    mod, name = ab_frame.parse_flag(
        "tinyrenderer_tpu_torch.ops.shadows:_GATE_VIA_MIN")
    assert name == "_GATE_VIA_MIN" and mod.__name__.endswith("ops.shadows")
    for spec in ("tinyrenderer_tpu_torch.ops.raster:_PLANES_ON_MXU",
                 "tinyrenderer_tpu_torch.ops.sampling:_WINDOWED_BLEND_PALLAS",
                 "tinyrenderer_tpu.ops.shadows:_GATE_VIA_MIN",
                 "tinyrenderer_tpu_torch.ops.shadows:_NO_SUCH_FLAG"):
        with pytest.raises(ValueError, match="Left out by decision"):
            ab_frame.parse_flag(spec)
    with pytest.raises(SystemExit, match="Left out by decision"):
        ab_frame.main(["--device", "cpu", "--flag",
                       "tinyrenderer_tpu_torch.ops.raster:_PLANES_ON_MXU"])
    ov = ab_frame.parse_cfg("sky_block_capacity=2048,bf16_attrs=false",
                            RenderConfig())
    assert ov == {"sky_block_capacity": 2048, "bf16_attrs": False}
    def build(o):
        return TEngine.from_world(
            demo.build_demo_world(n_cubes=4), camera=demo.build_demo_camera(
                128, 64), cfg=RenderConfig(**{**SMALL, **(o or {})}),
            device="cpu")
    rows = ab_frame.ab_cfg(build, {"sky_scale": 4}, rounds=1, frames=1)
    assert [r["name"] for r in rows] == ["base", "sky_scale=4"]
    te, _ = demo_pair
    rows = ab_frame.ab_flag(te, mod, name, rounds=1, frames=1)
    assert [r["name"] for r in rows] == ["_GATE_VIA_MIN=False",
                                         "_GATE_VIA_MIN=True"]
    assert mod._GATE_VIA_MIN == "auto"


def test_trace_top_ranks_device_events_only(tmp_path):
    """``parse`` sums a Chrome trace's device events (kernels, copies and
    fills) by name, costliest first, and ignores host events; it reads
    ``.json`` and ``.json.gz`` files and the newest trace of a
    directory."""
    events = [
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "dur": 900},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "dur": 800},
        {"ph": "X", "cat": "python_function", "name": "f.py(1): g",
         "dur": 700},
        {"ph": "X", "cat": "kernel", "name": "raster_kernel", "dur": 30},
        {"ph": "X", "cat": "kernel", "name": "shade_kernel", "dur": 50},
        {"ph": "X", "cat": "kernel", "name": "raster_kernel", "dur": 40},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "dur": 5},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset", "dur": 60},
        {"ph": "i", "cat": "kernel", "name": "marker"},
        {"ph": "M", "name": "process_name", "args": {"name": "GPU 0"}},
    ]
    import gzip
    path = tmp_path / "a.json.gz"
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": events}, f)
    rows = trace_top.parse(str(path))
    assert [(r["name"], r["us"], r["count"]) for r in rows] == [
        ("raster_kernel", 70.0, 2), ("Memset", 60.0, 1),
        ("shade_kernel", 50.0, 1), ("Memcpy HtoD", 5.0, 1)]
    assert [r["name"] for r in trace_top.parse(str(path), top=2)] == [
        "raster_kernel", "Memset"]
    newer = tmp_path / "b.json"
    newer.write_text(json.dumps({"traceEvents": events[3:4]}))
    os.utime(newer, (2e9, 2e9))
    assert trace_top.parse(str(tmp_path)) == [
        {"name": "raster_kernel", "us": 30.0, "count": 1}]


def test_trace_top_captures_a_compiled_frame_on_the_cpu(demo_pair, tmp_path):
    """``capture`` settles the engine and writes a Chrome trace of two
    compiled frames (on the CPU: the plain calls, host events only)."""
    te, _ = demo_pair
    path = trace_top.capture(te, str(tmp_path))
    assert os.path.getsize(path) > 0
    assert trace_top.parse(path) == []


def test_bench_binning_binners_agree_with_each_other_and_jax():
    """The two binners on a small pool of the reference's random
    triangles (some big ones): counts, overflow and each tile's ids under
    capacity agree, the big list sized to the pool; each equals the JAX
    binner on the same setup."""
    case = ("small", 512, 300, 1024, 512, 64, 128, 64)
    (_, setup), = bench_binning.make_setups("cpu", (case,))
    big_cap = bench_binning.big_capacity(setup, case)
    fns = bench_binning.binners(case, big_cap)
    dense, scatter = fns["dense"](setup), fns["scatter"](setup)
    agree = bench_binning.agreement(dense, scatter, case[7])
    assert agree["tiles_compared"] > 0 and int(scatter.big_overflow) > 0
    js = jraster.TriangleSetup(*(jnp.asarray(_np(getattr(setup, f)))
                                 for f in jraster.TriangleSetup._fields))
    W, H, th, tw, K = case[3:]
    for mine, theirs in (
            (dense, jraster.bin_triangles_dense(js, W, H, th, tw, K)),
            (scatter, jraster.bin_triangles_scatter(js, W, H, th, tw, K,
                                                    big_cap))):
        for f in ("ids", "counts", "rows", "overflow", "big_overflow"):
            np.testing.assert_array_equal(_np(getattr(mine, f)),
                                          np.asarray(getattr(theirs, f)), f)
    rows = bench_binning.bench_binning("cpu", rounds=1, frames=1,
                                       cases=(case,))
    assert rows[0]["big_capacity"] == big_cap and rows[0]["dense_ms"] > 0


def test_bench_sky_blocks_forms_agree_and_match_jax():
    """The sky op's forms at a small size: each row form equal to its
    block form, the RGBE forms within one RGBE step of the f32 ones; the
    frame's sky (``_sky_cf`` under the reference's ``_sky_image`` name)
    equal to JAX's ``_sky_image`` for both configurations, on the
    reference's mask."""
    inp = bench_sky_blocks.sky_inputs("cpu", S=32, W=256, H=128)
    forms = bench_sky_blocks.op_forms(inp, capacities=(8, 32))
    check = bench_sky_blocks.check_forms(forms, inp)
    assert set(check["max_rgbe_minus_f32"]) == {
        "blk_rgbe_K8", "blk_rgbe_K32", "flat_rgbe_K32"}
    assert 0 < max(check["max_rgbe_minus_f32"].values()) <= check["rgbe_step"]
    cube, rgbe = inp["cube"], inp["rgbe"]
    np.testing.assert_array_equal(
        _np(rgbe), np.asarray(jax.jit(jsampling.encode_rgbe_windowed)(
            jnp.asarray(_np(cube)))))
    valid = torch.ones((inp["PH"], inp["PW"]), dtype=torch.bool)
    valid[: inp["PH"] // 4] = False
    jcam = jframe._unpack_camera(jnp.asarray(
        JCamera.new_default(256, 128).to_raw()))
    jenv = jframe.EnvGPU(jnp.asarray(_np(cube)), None, None,
                         jnp.asarray(_np(rgbe)))
    env = bench_sky_blocks.framelib.EnvGPU(cube, None, None, rgbe)
    base = RenderConfig(width=256, height=128)
    for cfg in (dataclasses.replace(base, sky_block_capacity=64), base):
        sky, needed = bench_sky_blocks.sky_image(cfg, env, inp["cam"], valid)
        jsky, jneeded = jax.jit(
            lambda c, v, e, cfg=cfg: jframe._sky_image(
                JRenderConfig(**dataclasses.asdict(cfg)), e, c, v,
                inp["PW"], inp["PH"]))(jcam, jnp.asarray(_np(valid)), jenv)
        assert int(needed) == int(jneeded)
        np.testing.assert_allclose(_np(sky), np.asarray(jsky), rtol=0,
                                   atol=1e-6)
    rows = bench_sky_blocks.sky_pipeline(
        "cpu", 1, 1, configs={"x": dataclasses.replace(base,
                                                       sky_block_capacity=64)})
    assert rows[0]["config"] == "x" and rows[0]["median_ms"] > 0


def test_bench_gather_pcf_forms_are_bit_equal():
    """The f32[4] and u8[16] gathers of the same rows are bit-equal (the
    tool asserts it before timing); the four narrow taps read column 0."""
    args = bench_gather_pcf.make_inputs("cpu", rows=1024, table=8192)
    f = bench_gather_pcf.forms()
    a, b = f["f32x4"](*args), f["u8x16"](*args)
    assert a.shape == (1024, 4) and torch.equal(a.view(torch.int32),
                                                b.view(torch.int32))
    tab, _, idx = args
    assert torch.equal(f["4taps"](*args)[:, 1], tab[(idx + 1) % 8192, 0])
    rows = bench_gather_pcf.bench_gather("cpu", 1, 1, rows=1024, table=8192)
    assert [r["form"] for r in rows] == ["f32x4", "u8x16", "4taps"]


def test_dump_graph_parsers():
    """``kernel_nodes`` counts the kernel nodes of a DOT dump (the format
    of ``cudaGraphDebugDotPrint``'s verbose output: each kernel's mangled
    name and launch shape in its ID record) by kernel name, demangled
    where ``c++filt`` runs; ``op_sources`` finds the port's Python
    frames around a kernel's launch through its correlation id."""
    def node(i, name, launch):
        return (f'"graph_1_node_{i}"[style="bold" shape="record" label="'
                f'{{KERNEL\n| {{ID | {i} (topoId: {9 - i}) | {name}'
                f'\\<\\<\\<{launch},256,0\\>\\>\\>}}\n'
                f'| {{{{node handle | func handle}} | {{0x1 | 0x2}}}}\n'
                f'| {{priority | 0}}\n}}"];\n')
    raster = "_ZN12_GLOBAL__N_113raster_kernelILb0EEEvPKiPKfPiPfPyPjiiiiii"
    shade = "_ZN12_GLOBAL__N_112shade_kernelILb1EEEvPKf"
    dot = ('digraph dot {\nsubgraph cluster_1 {\n'
           + node(0, raster, "\\{255,32\\}") + node(1, shade, "510")
           + '"graph_1_node_2"[style="solid" shape="record" '
             'label="{MEMCPY\n| {ID | 2 (topoId: 7) | }}"];\n'
           + node(3, raster, "\\{255,32\\}") + "}\n}\n")
    assert dump_graph.kernel_nodes(dot, demangle_names=False) == {raster: 2,
                                                            shade: 1}
    names = dump_graph.kernel_nodes(dot)
    assert sum(names.values()) == 3
    assert any("raster_kernel" in n and c == 2 for n, c in names.items())
    py = "tinyrenderer_tpu_torch/ops/raster.py(562): rasterize_binned"
    events = [
        {"ph": "X", "cat": "python_function", "name": "x.py(1): main",
         "pid": 1, "tid": 1, "ts": 0, "dur": 100},
        {"ph": "X", "cat": "python_function",
         "name": "tinyrenderer_tpu_torch/render/frame.py(491): "
                 "_render_frame_fused", "pid": 1, "tid": 1, "ts": 5,
         "dur": 90},
        {"ph": "X", "cat": "python_function", "name": py, "pid": 1,
         "tid": 1, "ts": 10, "dur": 20},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "pid": 1, "tid": 1, "ts": 15, "dur": 2,
         "args": {"correlation": 7}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "pid": 1, "tid": 1, "ts": 50, "dur": 2,
         "args": {"correlation": 8}},
        {"ph": "X", "cat": "kernel", "name": "raster_kernel<64>", "pid": 0,
         "tid": 7, "ts": 20, "dur": 3, "args": {"correlation": 7}},
        {"ph": "X", "cat": "kernel", "name": "shade_kernel", "pid": 0,
         "tid": 7, "ts": 60, "dur": 3, "args": {"correlation": 8}},
    ]
    src = dump_graph.op_sources(events, ["raster_kernel", "shade_kernel",
                                         "nothing"])
    assert src["raster_kernel"] == [("raster_kernel<64>", [
        py, "tinyrenderer_tpu_torch/render/frame.py(491): "
            "_render_frame_fused"])]
    assert src["shade_kernel"] == [("shade_kernel", [
        "tinyrenderer_tpu_torch/render/frame.py(491): _render_frame_fused"])]
    assert src["nothing"] == []


def test_compiled_fn_debug_dump_reaches_its_graph(monkeypatch):
    """``CompiledFn(fn, debug_dump=path)`` asks its graph for a dump
    before the capture; without it nothing is asked (the engine's
    path)."""
    calls = []

    class Graph:
        def __init__(self, device):
            self.device = device

        def debug_dump_to(self, path):
            calls.append(path)

        def warm_up(self, run):
            run()

        def capture(self, run):
            return run()

        def replay(self):
            pass
    monkeypatch.setattr(compiled, "capture_backend", Graph)
    x = torch.ones(3)
    assert torch.equal(compiled.CompiledFn(lambda a: a + 1,
                                           debug_dump="g.dot")(x), x + 1)
    assert calls == ["g.dot"]
    compiled.CompiledFn(lambda a: a * 2)(x)
    assert calls == ["g.dot"]


def test_timing_harness_on_the_cpu():
    """``reduce`` sums every tensor of an output tree in float32; a body
    is called once when captured (inside its setup), then loops of
    ``frames`` calls a round, round-robin."""
    @dataclasses.dataclass
    class Out:
        a: torch.Tensor
        b: torch.Tensor
    tree = {"x": Out(torch.ones(2, 3), torch.tensor([True, False, True])),
            "y": (torch.arange(4, dtype=torch.int32),)}
    r = timing.reduce(tree)
    assert r.dtype == torch.float32 and float(r) == 6 + 2 + 6
    n, inside = [], []

    class Setup:
        def __enter__(self):
            inside.append(True)

        def __exit__(self, *a):
            inside.append(False)
    body = timing.capture(lambda t: n.append(float(t.sum())) or t.sum(),
                          torch.ones(2), setup=Setup)
    assert n == [2.0] and inside == [True, False]
    samples = timing.round_robin({"a": body}, rounds=3, frames=2,
                                 device="cpu", log=False)
    assert len(samples["a"]) == 3 and len(n) == 1 + 2 + 3 * 2
    row, = timing.summary(samples)
    assert row["name"] == "a" and row["min_ms"] <= row["median_ms"]


@pytest.mark.parametrize("tool", ["bench_stages", "profile_highpoly",
                                  "trace_top", "profile_frame", "ab_frame",
                                  "bench_binning", "bench_sky_blocks",
                                  "bench_gather_pcf", "dump_graph"])
def test_tools_run_on_the_card_by_default(tool, capsys):
    """Each tool's CLI defaults to ``--device cuda`` and, without a card,
    exits non-zero naming CUDA before it builds anything."""
    import importlib
    mod = importlib.import_module(f"tinyrenderer_tpu_torch.tools.{tool}")
    argv = {"ab_frame": ["--cfg", "sky_scale=4"]}.get(tool, [])
    with pytest.raises(SystemExit) as e:
        mod.main(argv)
    assert e.value.code != 0
    assert "no CUDA device" in capsys.readouterr().err

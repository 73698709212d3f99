"""Port parity for the ops of the unfused deferred chain, on the CPU: K6's
plain version (fused raster + resolve) against the JAX kernel in Pallas
interpret mode, and the evaluation of selected rows, the tiled resolve,
the GBuffer assembly, ``shade_deferred``, screen-space reflections and the
resizes against the jitted JAX functions. Inputs are made from seeded
numpy generators and handed to both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinyrenderer_tpu.ops import compact as jcompact
from tinyrenderer_tpu.ops import env as jenv
from tinyrenderer_tpu.ops import post as jpost
from tinyrenderer_tpu.ops import raster as jraster
from tinyrenderer_tpu.ops import resolve as jresolve
from tinyrenderer_tpu.ops import sampling as jsampling
from tinyrenderer_tpu.ops import shading as jshading
from tinyrenderer_tpu_torch.ops import compact as tcompact
from tinyrenderer_tpu_torch.ops import env as tenv
from tinyrenderer_tpu_torch.ops import post as tpost
from tinyrenderer_tpu_torch.ops import raster as traster
from tinyrenderer_tpu_torch.ops import resolve as tresolve
from tinyrenderer_tpu_torch.ops import sampling as tsampling
from tinyrenderer_tpu_torch.ops import shading as tshading
from tinyrenderer_tpu_torch.scene import demo

W, H, TH, TW = 256, 128, 16, 128
ROW_D = 53


def _t(a):
    return torch.from_numpy(np.array(a))


def _unit(rng, shape):
    v = rng.standard_normal(shape).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _jbins_to_torch(b) -> traster.Bins:
    return traster.Bins(ids=_t(b.ids), rows=_t(b.rows), counts=_t(b.counts),
                        overflow=_t(b.overflow), big_overflow=_t(b.big_overflow))


# ---- K6: fused raster + resolve ----------------------------------------

def _k6_bins(case: str):
    """tests/test_raster.py's random setup (clip from NDC, triangles over a
    shared vertex pool) in four variants: random; every triangle in the left
    half (empty tiles); each triangle twice (equal depths: the larger id
    wins); 600 triangles into 32-row bins (counts clamp at K)."""
    rng = np.random.default_rng({"random": 1, "empty_tiles": 2,
                                 "duplicates": 3, "full_bins": 4}[case])
    V, T, K = 120, 300, 128
    ndc = rng.uniform(-1.3, 1.3, size=(V, 3)).astype(np.float32)
    ndc[:, 2] = rng.uniform(0.05, 0.95, size=V)
    if case == "empty_tiles":
        ndc[:, 0] = rng.uniform(-1.0, -0.05, size=V)
    clip = np.concatenate([ndc, np.ones((V, 1), np.float32)], axis=1)
    tri = rng.integers(0, V, size=(T, 3)).astype(np.int32)
    if case == "duplicates":
        tri = np.repeat(tri[:T // 2], 2, axis=0)
    if case == "full_bins":
        tri = rng.integers(0, V, size=(600, 3)).astype(np.int32)
        K = 32
    setup = jraster.triangle_setup(jnp.asarray(clip), jnp.asarray(tri),
                                   jnp.ones((tri.shape[0],), bool), W, H,
                                   "none")
    bins = jraster.bin_triangles(setup, W, H, TH, TW, K)
    table = rng.standard_normal((tri.shape[0], ROW_D)).astype(np.float32)
    return bins, table


@pytest.mark.parametrize("case", ["random", "empty_tiles", "duplicates",
                                  "full_bins"])
def test_raster_resolve_matches_pallas(case):
    """K6's plain version against rasterize_resolve_binned (interpret mode)
    with the table padded to 64 columns and the output cropped back, as the
    frame calls it: tri_id and depth bit-equal, sel equal (the one-hot
    product has one non-zero term)."""
    jb, table = _k6_bins(case)
    jt = jnp.pad(jnp.asarray(table), ((0, 0), (0, 64 - ROW_D)))
    jid, jz, jsel = jraster.rasterize_resolve_binned(jb, jt, TH, TW)
    tid, tz, tsel = traster.rasterize_resolve_binned(_jbins_to_torch(jb),
                                                     _t(table), TH, TW)
    jid, jz, jsel = np.asarray(jid), np.asarray(jz), np.asarray(jsel)
    assert (jid >= 0).mean() > 0.05
    np.testing.assert_array_equal(tid.numpy(), jid)
    np.testing.assert_array_equal(tz.numpy().view(np.int32), jz.view(np.int32))
    np.testing.assert_array_equal(tsel.numpy(), jsel[..., :ROW_D])
    assert (tsel.numpy()[jid < 0] == 0).all()
    counts = np.asarray(jb.counts)
    if case == "empty_tiles":
        assert (counts == 0).any() and (jid[:, W // 2 + 8:] == -1).all()
    if case == "duplicates":      # every winner is the second of its pair
        assert (jid[jid >= 0] % 2 == 1).all()
    if case == "full_bins":
        assert int(jb.overflow) > 32 and counts.max() == 32


def test_raster_resolve_equals_two_pass():
    """K6's plain version is K1's plain version plus the winner's row."""
    jb, table = _k6_bins("random")
    tb = _jbins_to_torch(jb)
    tid, tz, tsel = traster.rasterize_resolve_binned_ref(tb, _t(table), TH, TW)
    rid, rz = traster.rasterize_binned_ref(tb, TH, TW)
    assert torch.equal(tid, rid) and torch.equal(tz, rz)
    hit = rid >= 0
    assert torch.equal(tsel[hit], _t(table)[rid[hit].long()])


# ---- evaluation of selected rows, the tiled resolve --------------------

def _table_and_ids(seed: int):
    """A full-layout table from random triangles (test_torch_resolve's
    generator) and its K1 visibility on dense bins."""
    from test_torch_resolve import _inputs, _tables
    d = _inputs(seed)
    js, jt, tt = _tables(d, False)
    jb = jraster.bin_triangles_dense(js, W, H, TH, TW, 128)
    jid, _ = jraster.rasterize_binned(jb, TH, TW, use_pallas=True)
    return jb, jt, tt, jid


def _assert_attrs_equal(t, j):
    for f in ("world", "uv", "normal", "tangent", "bitangent", "flat",
              "record", "object_id", "valid"):
        np.testing.assert_array_equal(getattr(t, f).numpy(),
                                      np.asarray(getattr(j, f)), err_msg=f)


def test_resolve_attrs_from_sel_matches():
    """K6's output evaluated at pixel centres: bit-equal to the jitted JAX
    epilogue on the same winners and rows."""
    jb, jt, tt, _ = _table_and_ids(5)
    jtp = jnp.pad(jnp.asarray(jt), ((0, 0), (0, 64 - ROW_D)))
    jid, _, jsel = jraster.rasterize_resolve_binned(jb, jtp, TH, TW)
    j = jax.jit(jresolve.resolve_attrs_from_sel)(jid, jsel[..., :ROW_D])
    tid, _, tsel = traster.rasterize_resolve_binned(_jbins_to_torch(jb), tt,
                                                    TH, TW)
    _assert_attrs_equal(tresolve.resolve_attrs_from_sel(tid, tsel), j)


def test_resolve_attrs_tiled_matches():
    """The kernel-free tiled resolve (bf16 one-hot over the tile's bin) is a
    gather of the winner's row: the port's select + eval in full float32
    is bit-equal to the jitted JAX function."""
    jb, jt, tt, jid = _table_and_ids(6)
    j = jax.jit(jresolve.resolve_attrs_tiled, static_argnums=(3, 4))(
        jid, jb.ids, jnp.asarray(jt), TH, TW)
    assert (np.asarray(jid) >= 0).mean() > 0.2
    _assert_attrs_equal(tresolve.resolve_attrs_pallas(_t(jid), tt, bf16=False),
                        j)


# ---- GBuffer assembly -------------------------------------------------

def _attrs(seed: int):
    """Random resolved attributes: an affine uv field with a fold (several
    mip levels), unit TBN, ~85% coverage, use_tex on half the pixels, and
    records of a 4-texture pool."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    uv = np.stack([xx * 0.013 + yy * 0.002 + np.sin(xx * 0.05) * 0.3,
                   yy * 0.011 - xx * 0.003], -1).astype(np.float32)
    flat = rng.uniform(0.05, 0.95, (H, W, 6)).astype(np.float32)
    flat[..., 5] = (rng.uniform(size=(H, W)) < 0.5).astype(np.float32)
    valid = rng.uniform(size=(H, W)) < 0.85
    oid = np.where(valid, rng.integers(1, 40, (H, W)), 0).astype(np.int32)
    return dict(world=rng.uniform(-3, 3, (H, W, 3)).astype(np.float32), uv=uv,
                normal=_unit(rng, (H, W, 3)), tangent=_unit(rng, (H, W, 3)),
                bitangent=_unit(rng, (H, W, 3)), flat=flat,
                record=rng.integers(0, 4, (H, W)).astype(np.int32),
                object_id=oid, valid=valid)


@pytest.mark.parametrize("mode", ["flat_only", "textured", "texture_scale_2",
                                  "compacted"])
def test_resolve_gbuffer_from_attrs_matches(mode):
    """GBuffer assembly against the jitted JAX function: the flat-only
    branch bit-equal; the material sample (windowed u8 pool, dithered
    filter), its strided rate-2 form (dilated mask, integer bilinear
    upsample) and the block-compacted sample within 2e-6 (normal mapping:
    XLA contracts the TBN sum's multiply-adds, the port spells out one
    order), the rate-2 form within 1e-5 (its upsample rounds the two-tap
    blend where XLA fuses it, and normalizing the mapped normal scales
    that ulp up); the needed-block count equal."""
    a = _attrs(11)
    rng = np.random.default_rng(12)
    mips = [rng.uniform(0, 1, (4, s, s, 9)).astype(np.float32)
            for s in (16, 8, 4, 2)]
    jpool = jsampling.pack_texture_pool(mips, windowed=True, u8=True,
                                        morton=True)
    tpool = tsampling.pool_from_numpy(vars(jpool), "cpu")
    depth = rng.uniform(0, 1, (H, W)).astype(np.float32)
    kw = dict(texture_filter="dithered",
              texture_scale=2 if mode == "texture_scale_2" else 1,
              tex_block_capacity=8 if mode == "compacted" else 0,
              sample_textures=mode != "flat_only")
    jr = jresolve.ResolvedAttrs(**{k: jnp.asarray(v) for k, v in a.items()})
    jg, jn = jax.jit(lambda r, tid, d: jresolve.resolve_gbuffer_from_attrs(
        r, tid, d, jpool, **kw))(jr, jnp.asarray(a["object_id"]),
                                 jnp.asarray(depth))
    tr = tresolve.ResolvedAttrs(**{k: _t(v) for k, v in a.items()})
    tg, tn = tresolve.resolve_gbuffer_from_attrs(tr, _t(a["object_id"]),
                                                 _t(depth), tpool, **kw)
    assert int(tn) == int(jn)
    if mode == "compacted":
        assert 0 < int(tn)
    for f in ("depth", "object_id", "mask"):
        np.testing.assert_array_equal(getattr(tg, f).numpy(),
                                      np.asarray(getattr(jg, f)), err_msg=f)
    tol = {"flat_only": 0, "texture_scale_2": 1e-5}.get(mode, 2e-6)
    for f in ("position", "normal", "albedo", "rough_metal_ao"):
        np.testing.assert_allclose(getattr(tg, f).numpy(),
                                   np.asarray(getattr(jg, f)), rtol=0,
                                   atol=tol, err_msg=f)
    if mode != "flat_only":       # the sample was read, not the flat params
        use = a["valid"] & (a["flat"][..., 5] > 0.5)
        assert (np.abs(tg.albedo.numpy() - a["flat"][..., :3])[use] > 1e-3).any()


def test_dilate_mask_matches():
    m = np.random.default_rng(3).uniform(size=(37, 53)) < 0.05
    m[0, 0] = m[-1, -1] = m[0, -1] = True
    np.testing.assert_array_equal(tcompact.dilate_mask(_t(m)).numpy(),
                                  np.asarray(jcompact.dilate_mask(jnp.asarray(m))))


# ---- deferred shading ---------------------------------------------------

def _gbuffer(seed: int, hh: int = 64, ww: int = 96):
    rng = np.random.default_rng(seed)
    rma = np.stack([rng.uniform(0.05, 1, (hh, ww)), rng.uniform(0, 1, (hh, ww)),
                    np.ones((hh, ww))], -1).astype(np.float32)
    return dict(position=rng.uniform(-3, 3, (hh, ww, 3)).astype(np.float32),
                normal=_unit(rng, (hh, ww, 3)),
                albedo=rng.uniform(0, 1, (hh, ww, 3)).astype(np.float32),
                rough_metal_ao=rma, depth=np.zeros((hh, ww), np.float32),
                object_id=np.zeros((hh, ww), np.int32),
                mask=rng.uniform(size=(hh, ww)) > 0.2)


def test_sh_eval_irradiance_matches():
    """SH-9 evaluation within 2e-7 (the jitted einsum sums in its own
    order)."""
    rng = np.random.default_rng(2)
    sh = rng.standard_normal((9, 3)).astype(np.float32) * 0.3
    n = _unit(rng, (64, 96, 3))
    j = jax.jit(jenv.sh_eval_irradiance)(jnp.asarray(sh), jnp.asarray(n))
    np.testing.assert_allclose(tenv.sh_eval_irradiance(_t(sh), _t(n)).numpy(),
                               np.asarray(j), rtol=0, atol=2e-7)


@pytest.mark.parametrize("P,D", [(0, 0), (1, 0), (0, 1), (2, 1), (1, 2),
                                 (2, 2)])
@pytest.mark.parametrize("ibl", [True, False])
def test_shade_deferred_matches(P, D, ibl):
    """Cook-Torrance per point and directional light, gated on shadow > 0
    (gates of 0, 0.5 and 1), SH-9 ambient times ao, zero off the mask;
    against the jitted JAX pass, rtol 1e-4 and atol 1e-5 (the same
    formulas; XLA contracts multiply-adds and reassociates sums in places
    the port does not follow)."""
    g = _gbuffer(7)
    hh, ww = g["mask"].shape
    rng = np.random.default_rng(8)
    lights = dict(point_position=rng.uniform(-4, 4, (P, 3)).astype(np.float32),
                  point_color=rng.uniform(0, 5, (P, 3)).astype(np.float32),
                  dir_direction=_unit(rng, (D, 3)),
                  dir_color=rng.uniform(0, 3, (D, 3)).astype(np.float32),
                  dir_viewproj=np.tile(np.eye(4, dtype=np.float32), (D, 1, 1)))
    sh = rng.standard_normal((9, 3)).astype(np.float32) * 0.3 if ibl else None
    gates = rng.choice(np.float32([0.0, 0.5, 1.0]), (P + D, hh, ww))
    cam = np.array([0.5, 1.0, 6.0], np.float32)

    def jf(g, cam, lights, gates, sh):
        return jshading.shade_deferred(
            g, cam, lights, P, D, sh, lambda i, p: gates[i],
            lambda i, p: gates[P + i])
    j = jax.jit(jf)(jresolve.GBuffer(**{k: jnp.asarray(v) for k, v in g.items()}),
                    jnp.asarray(cam),
                    jshading.ShadingLights(**{k: jnp.asarray(v)
                                              for k, v in lights.items()}),
                    jnp.asarray(gates), None if sh is None else jnp.asarray(sh))
    t = tshading.shade_deferred(
        tresolve.GBuffer(**{k: _t(v) for k, v in g.items()}), _t(cam),
        tshading.ShadingLights(**{k: _t(v) for k, v in lights.items()}), P, D,
        None if sh is None else _t(sh), _t(gates))
    j = np.asarray(j)
    np.testing.assert_allclose(t.numpy(), j, rtol=1e-4, atol=1e-5)
    assert (t.numpy()[~g["mask"]] == 0).all()
    if P + D or ibl:
        assert (np.abs(j[g["mask"]]) > 1e-3).mean() > 0.2


# ---- screen-space reflections -------------------------------------------

def _ssr_inputs(seed: int):
    """A depth field that a reflected ray can hit, the demo camera at the
    map's size, GBuffer-like positions and normals."""
    rng = np.random.default_rng(seed)
    hh, ww = 64, 96
    cam = demo.build_demo_camera(ww, hh).to_raw()
    return dict(hdr=rng.uniform(0, 2, (hh, ww, 3)).astype(np.float32),
                depth=rng.uniform(0.0, 1.0, (hh, ww)).astype(np.float32),
                position=rng.uniform(-2, 2, (hh, ww, 3)).astype(np.float32),
                normal=_unit(rng, (hh, ww, 3)),
                view_proj=cam[0:16].reshape(4, 4), camera_pos=cam[80:83],
                mask=rng.uniform(size=(hh, ww)) > 0.2,
                rough=rng.uniform(0.0, 1.0, (hh, ww)).astype(np.float32))


@pytest.mark.parametrize("thickness", [0.25, 5.0])
@pytest.mark.parametrize("surface", ["smooth", "rough"])
def test_screen_space_reflections_matches(thickness, surface):
    """Strength 0.5 (the shipped 0 is a pass-through): the 64 coarse taps
    of the 4x4 max depth, 8 bisection taps, the thickness test, self-hit
    rejection and the (1 - roughness)^2 gloss. Against the jitted JAX
    pass: equal hit sets, values within 2.5e-7 (the reflected colour is
    blended with one fused multiply-add)."""
    d = _ssr_inputs(4)
    rough = d["rough"] * (0.2 if surface == "smooth" else 1.0)
    args = [d[k] for k in ("hdr", "depth", "position", "normal", "view_proj",
                           "camera_pos")]
    scal = [np.float32(thickness), np.float32(0.5)]
    j = jax.jit(lambda *a: jpost.screen_space_reflections(
        *a[:8], mask=a[8], roughness=a[9]))(
        *map(jnp.asarray, args + scal + [d["mask"], rough]))
    t = tpost.screen_space_reflections(*map(_t, args + scal), mask=_t(d["mask"]),
                                       roughness=_t(rough))
    j = np.asarray(j)
    changed = (np.abs(j - d["hdr"]) > 1e-6).any(-1)
    assert changed.mean() > 0.1
    np.testing.assert_array_equal((np.abs(t.numpy() - d["hdr"]) > 1e-6).any(-1),
                                  changed)
    np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=2.5e-7)


def test_project_ray_points_matches():
    """The projection of position + refl * t, two ulp of the largest value
    from the jitted einsum at most (the port spells out one multiply-add
    order)."""
    rng = np.random.default_rng(5)
    d = _ssr_inputs(4)
    ts = rng.uniform(0, 10, d["depth"].shape).astype(np.float32)
    args = (d["position"], _unit(rng, d["position"].shape), ts, d["view_proj"])
    j = jax.jit(jpost._project_ray_points)(*map(jnp.asarray, args))
    t = tpost._project_ray_points(*map(_t, args))
    for a, b in zip(t, j):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=2 * float(np.spacing(np.abs(b).max())))


# ---- resizes ------------------------------------------------------------

@pytest.mark.parametrize("sy,sx", [(2, 2), (2, 3), (4, 4)])
def test_upsample_bilinear_int_matches(sy, sx):
    """(H, W, C) integer-factor upsample: within 2 ulp (rtol 2.5e-7) of
    the jitted phase-wise form (XLA fuses the two-tap blend)."""
    img = np.random.default_rng(6).uniform(0, 4, (27, 48, 9)).astype(np.float32)
    j = jax.jit(jpost.upsample_bilinear_int, static_argnums=(1, 2))(
        jnp.asarray(img), sy, sx)
    t = tpost.upsample_bilinear_int(_t(img), sy, sx)
    assert t.shape == (27 * sy, 48 * sx, 9)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=2.5e-7,
                               atol=1e-7)


@pytest.mark.parametrize("hw,out", [((27, 48), (36, 64)), ((96, 192), (128, 256)),
                                    ((81, 144), (108, 192))])
def test_resize_bilinear_matches(hw, out):
    """The scaled frame's HDR upsample for a non-integer factor (4/3, as
    render_scale_pct 75 gives): F.interpolate against jax.image.resize
    bilinear within 1e-6, edge rows and columns included (jax renormalizes
    its edge weights, which equals the clamp)."""
    img = np.random.default_rng(7).uniform(0, 4, hw + (3,)).astype(np.float32)
    j = np.asarray(jax.image.resize(jnp.asarray(img), out + (3,), "bilinear"))
    t = tpost.resize_bilinear(_t(img), *out).numpy()
    np.testing.assert_allclose(t, j, rtol=0, atol=1e-6)
    for edge in (t[0], t[-1], t[:, 0], t[:, -1]):
        assert np.isfinite(edge).all()
    np.testing.assert_allclose(t[0], j[0], rtol=0, atol=1e-6)
    np.testing.assert_allclose(t[:, -1], j[:, -1], rtol=0, atol=1e-6)


@pytest.mark.parametrize("hw,out", [((27, 48), (36, 64)), ((96, 192), (128, 256)),
                                    ((810, 1440), (1080, 1920))])
def test_resize_nearest_matches(hw, out):
    """Pick ids and depth of the scaled frame: the same indices as
    jax.image.resize nearest, so the ids are exact."""
    rng = np.random.default_rng(8)
    ids = rng.integers(0, 1 << 20, hw).astype(np.int32)
    z = rng.uniform(0, 1, hw).astype(np.float32)
    for a in (ids, z):
        np.testing.assert_array_equal(
            tpost.resize_nearest(_t(a), *out).numpy(),
            np.asarray(jax.image.resize(jnp.asarray(a), out, "nearest")))


@pytest.mark.parametrize("size", [8, 96])
def test_resize_linear_matches(size):
    """The irradiance map's resize to irradiance_size (antialiased down,
    interpolating up) within 2e-6 of jax.image.resize."""
    irr = np.random.default_rng(9).uniform(0, 1, (6, 64, 64, 3)).astype(np.float32)
    j = jax.image.resize(jnp.asarray(irr), (6, size, size, 3), "bilinear")
    t = tpost.resize_linear(_t(irr), (6, size, size, 3))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=2e-6)

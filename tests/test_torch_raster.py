"""Port parity: tinyrenderer_tpu_torch.ops.raster against the JAX raster.

Random clip-space triangles from a seeded numpy generator go through both
packages on the CPU; the JAX raster kernel runs in Pallas interpret mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import planes
import pytest
import torch

from tinyrenderer_tpu.ops import raster as jraster
from tinyrenderer_tpu_torch.ops import raster as traster


def _clip_tris(seed: int, T: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    V = 3 * T
    w = rng.uniform(0.5, 2.0, V)
    clip = np.stack([rng.uniform(-1.2, 1.2, V) * w, rng.uniform(-1.2, 1.2, V) * w,
                     rng.uniform(0.05, 0.9, V) * w, w], axis=1).astype(np.float32)
    clip[:4, 3] = -0.5                       # a few triangles behind the eye
    vidx = rng.permutation(V).astype(np.int32).reshape(T, 3)
    mask = rng.uniform(size=T) > 0.1
    return clip, vidx, mask


def _t(a):
    return torch.from_numpy(np.array(a))


def _jbins_to_torch(b) -> traster.Bins:
    return traster.Bins(ids=_t(b.ids), rows=_t(b.rows), counts=_t(b.counts),
                        overflow=_t(b.overflow), big_overflow=_t(b.big_overflow))


# the setup's columns the plane constants do not feed: the edge slopes, the
# id and the corners' 1/w (tests/planes.py)
_UPSTREAM = [0, 1, 3, 4, 6, 7, 12, 13, 14, 15]


def _hold_planes(t, j, W, H):
    """The port's plane columns against the JAX package's under the
    parity decision (tests/planes.py): at the frame's pixel centres that
    each valid triangle covers, the port's edge and depth planes are no
    farther from the float64 planes of the frame's float32 corners than
    the JAX package's (``planes.plane_distance``). Returns both
    distances."""
    r64 = planes.float64_rows(t).double()
    d_port = planes.plane_distance(t.rows, r64, t.screen, t.valid, W, H)
    d_jax = planes.plane_distance(torch.tensor(np.asarray(j.rows)), r64,
                                  t.screen, t.valid, W, H)
    assert d_port <= d_jax, (d_port, d_jax)
    return d_port, d_jax


@pytest.mark.parametrize("cull", ["back", "front", "none"])
def test_triangle_setup_matches(cull):
    """Compiled (jit) setup, as the reference frame runs it: its fused
    multiply-adds are the ones the port reproduces (ops/fp.py). The plane
    columns are held under the parity decision (``_hold_planes``)."""
    clip, vidx, mask = _clip_tris(1, 96)
    j = jax.jit(jraster.triangle_setup, static_argnums=(3, 4, 5))(
        jnp.asarray(clip), jnp.asarray(vidx), jnp.asarray(mask), 256, 128, cull)
    t = traster.triangle_setup(_t(clip), _t(vidx), _t(mask), 256, 128, cull)
    tj = planes.jax_setup(_t(clip), _t(vidx), _t(mask), 256, 128, cull)
    np.testing.assert_array_equal(t.valid.numpy(), np.asarray(j.valid))
    for name in ("bbox", "screen", "inv_w", "z_ndc"):
        np.testing.assert_allclose(getattr(t, name).numpy(),
                                   np.asarray(getattr(j, name)), rtol=1e-6,
                                   err_msg=name)
    np.testing.assert_allclose(t.rows.numpy()[:, _UPSTREAM],
                               np.asarray(j.rows)[:, _UPSTREAM], rtol=1e-6)
    np.testing.assert_allclose(tj.rows.numpy(), np.asarray(j.rows), rtol=1e-6)
    _hold_planes(t, j, 256, 128)


@pytest.mark.parametrize("W,H", [(256, 96), (1536, 832), (1920, 1088)])
@pytest.mark.parametrize("cull", ["back", "none"])
def test_triangle_setup_bit_equal_at_any_size(W, H, cull):
    """Padded sizes that are not powers of two (the 75% frame, 1080p): the
    compiled setup fuses the screen scaling into the corner differences,
    and the port follows it, so every output upstream of the plane
    constants is bit-equal, and so are the rows under the JAX package's
    rounding of the planes; the port's own plane columns are held under the
    parity decision (``_hold_planes``)."""
    clip, vidx, mask = _clip_tris(5, 200)
    j = jax.jit(jraster.triangle_setup, static_argnums=(3, 4, 5))(
        jnp.asarray(clip), jnp.asarray(vidx), jnp.asarray(mask), W, H, cull)
    t = traster.triangle_setup(_t(clip), _t(vidx), _t(mask), W, H, cull)
    tj = planes.jax_setup(_t(clip), _t(vidx), _t(mask), W, H, cull)
    assert np.asarray(j.valid).mean() > 0.2
    for name in ("valid", "bbox", "screen", "inv_w", "z_ndc"):
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(j, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(t.rows.numpy()[:, _UPSTREAM],
                                  np.asarray(j.rows)[:, _UPSTREAM])
    np.testing.assert_array_equal(tj.rows.numpy(), np.asarray(j.rows))
    _hold_planes(t, j, W, H)


@pytest.mark.parametrize("capacity", [128, 32])   # sort branch, top_k branch
def test_bin_triangles_dense_matches(capacity):
    clip, vidx, mask = _clip_tris(2, 80)
    j = jraster.triangle_setup(jnp.asarray(clip), jnp.asarray(vidx),
                               jnp.asarray(mask), 256, 128, "none")
    jb = jraster.bin_triangles_dense(j, 256, 128, 16, 128, capacity)
    t = traster.triangle_setup(_t(clip), _t(vidx), _t(mask), 256, 128, "none")
    # bin the same setup on both sides: binning is exact integer work
    t.bbox, t.valid, t.rows = _t(j.bbox), _t(j.valid), _t(j.rows)
    tb = traster.bin_triangles_dense(t, 256, 128, 16, 128, capacity)
    np.testing.assert_array_equal(tb.ids.numpy(), np.asarray(jb.ids))
    np.testing.assert_array_equal(tb.counts.numpy(), np.asarray(jb.counts))
    np.testing.assert_array_equal(tb.rows.numpy(), np.asarray(jb.rows))
    assert int(tb.overflow) == int(jb.overflow)


@pytest.mark.parametrize("view", ["main", "shadow"])
def test_rasterize_binned_matches_pallas(view):
    """K1's plain version against the Pallas kernel on the same bins:
    tri_id exact, depth bit-equal."""
    W, H, th, tw, K, cull = {"main": (256, 128, 16, 128, 128, "back"),
                             "shadow": (128, 128, 128, 128, 128, "front")}[view]
    clip, vidx, mask = _clip_tris(3, 120)
    j = jraster.triangle_setup(jnp.asarray(clip), jnp.asarray(vidx),
                               jnp.asarray(mask), W, H, cull)
    jb = jraster.bin_triangles_dense(j, W, H, th, tw, K)
    jid, jz = jraster.rasterize_binned(jb, th, tw, use_pallas=True)
    tid, tz = traster.rasterize_binned(_jbins_to_torch(jb), th, tw)
    assert (np.asarray(jid) >= 0).mean() > 0.2     # the scene covers pixels
    np.testing.assert_array_equal(tid.numpy(), np.asarray(jid))
    np.testing.assert_array_equal(tz.numpy().view(np.int32),
                                  np.asarray(jz).view(np.int32))


@pytest.mark.parametrize("T", [4096, 4097])    # dense, scatter
def test_bin_triangles_dispatch_matches(T):
    """bin_triangles dispatches on the pool size as the reference: dense up
    to 4096 triangles, the two-level scatter binner above (bigs first,
    then smalls in ascending id)."""
    clip, vidx, mask = _clip_tris(4, T)
    j = jraster.triangle_setup(jnp.asarray(clip), jnp.asarray(vidx),
                               jnp.asarray(mask), 256, 128, "none")
    jb = jraster.bin_triangles(j, 256, 128, 16, 128, 512, big_capacity=256)
    t = traster.triangle_setup(_t(clip), _t(vidx), _t(mask), 256, 128, "none")
    t.bbox, t.valid, t.rows = _t(j.bbox), _t(j.valid), _t(j.rows)
    tb = traster.bin_triangles(t, 256, 128, 16, 128, 512, big_capacity=256)
    for f in ("ids", "rows", "counts", "overflow", "big_overflow"):
        np.testing.assert_array_equal(getattr(tb, f).numpy(),
                                      np.asarray(getattr(jb, f)), err_msg=f)
    assert (int(tb.big_overflow) > 0) == (T > 4096)


def _far_sphere_triangles(W: int, H: int):
    """Clip-space corners of three ``uv_sphere(78, 78)`` meshes of radius
    1 at 6, 8.5 and 11 units from the eye, toward the frame's bottom-right
    corner, under the engine's camera (reverse-Z, near 0.1)."""
    from tinyrenderer_tpu_torch.assets import mesh as meshlib
    from tinyrenderer_tpu_torch.scene.camera import Camera
    cam = Camera.new_default(W, H)
    cam.aspect = W / H
    cam.position = np.zeros(3, np.float32)
    cam.look_at(np.array([1.0, 0.0, 0.0], np.float32))
    vp = (cam.proj_matrix() @ cam.view_matrix()).astype(np.float32)
    m = meshlib.uv_sphere(78, 78)
    pos = np.asarray(m.positions, np.float32)
    tri = np.asarray(m.indices, np.int32).reshape(-1, 3)
    clips, vidx = [], []
    for k, (d, dy, dz) in enumerate([(6.0, -2.0, 3.0), (8.5, -3.0, 5.0),
                                     (11.0, -4.5, 7.5)]):
        p = pos + np.array([d, dy, dz], np.float32)
        clips.append((np.c_[p, np.ones(len(p), np.float32)] @ vp.T)
                     .astype(np.float32))
        vidx.append(tri + k * len(pos))
    return np.concatenate(clips), np.concatenate(vidx)


def _doubled_areas_and_sides(setup) -> tuple[np.ndarray, np.ndarray]:
    """Each triangle's doubled area (px^2) and its bounding box's longer
    side (px), from its float32 screen corners in float64."""
    sc = setup.screen.double().numpy()
    (x0, y0), (x1, y1), (x2, y2) = (sc[:, k].T for k in range(3))
    area = np.abs((x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0))
    return area, np.maximum(np.ptp(sc[..., 0], 1), np.ptp(sc[..., 1], 1))


def _far_from_the_origin(setup, sel, W: int, H: int) -> bool:
    sc = setup.screen.numpy()[sel]
    return bool(sc[..., 0].min() > W / 2 and sc[..., 1].min() > H / 2)


def _depth_plane_distance(setup, rows, sel) -> tuple[float, int, float]:
    """The largest relative distance, over the covered pixel centres of the
    triangles ``sel`` selects, between the depth plane of ``rows`` as K1
    evaluates it (both orders of ``fp.plane``) and the plane through the
    triangle's corners (its float32 screen corners and depths) in
    float64; the pixels counted; the largest |zx * px|."""
    from tinyrenderer_tpu_torch.ops import fp
    sc = setup.screen.double().numpy()
    z = setup.z_ndc.double().numpy()
    (x0, y0), (x1, y1), (x2, y2) = (sc[:, k].T for k in range(3))
    area = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)
    worst, n, zxp = 0.0, 0, 0.0
    for t in np.nonzero(sel)[0]:
        px, py = np.meshgrid(
            np.arange(np.floor(sc[t, :, 0].min()), np.ceil(sc[t, :, 0].max())) + 0.5,
            np.arange(np.floor(sc[t, :, 1].min()), np.ceil(sc[t, :, 1].max())) + 0.5)
        b0 = ((x1[t] - px) * (y2[t] - py) - (x2[t] - px) * (y1[t] - py)) / area[t]
        b1 = ((x2[t] - px) * (y0[t] - py) - (x0[t] - px) * (y2[t] - py)) / area[t]
        b2 = 1.0 - b0 - b1
        inside = (b0 >= 0) & (b1 >= 0) & (b2 >= 0)
        if not inside.any():
            continue
        exact = (b0 * z[t, 0] + b1 * z[t, 1] + b2 * z[t, 2])[inside]
        r = torch.tensor(rows[t])
        fx = torch.from_numpy(px[inside].astype(np.float32))
        fy = torch.from_numpy(py[inside].astype(np.float32))
        for mxu in (False, True):
            got = fp.plane_ref(r[9], r[10], r[11], fx, fy, mxu).double().numpy()
            worst = max(worst, float((np.abs(got - exact) / np.abs(exact)).max()))
        n += int(inside.sum())
        zxp = max(zxp, float(np.abs(r[9].item() * fx.double().numpy()).max()))
    return worst, n, zxp


def _witness(clip, vidx, pick, W: int = 1920, H: int = 1080):
    """The port's and the JAX package's depth-plane distances
    (``_depth_plane_distance``) over the triangles ``pick(areas, sides)``
    selects among the valid ones, which must lie in the frame's far
    quarter; the pixels counted."""
    mask = np.ones(len(vidx), bool)
    t = traster.triangle_setup(_t(clip), _t(vidx), _t(mask), W, H, "back")
    sel = t.valid.numpy() & pick(*_doubled_areas_and_sides(t))
    assert _far_from_the_origin(t, sel, W, H)
    port, n, zxp = _depth_plane_distance(t, t.rows.numpy(), sel)
    j = jax.jit(jraster.triangle_setup, static_argnums=(3, 4, 5))(
        jnp.asarray(clip), jnp.asarray(vidx), jnp.asarray(mask), W, H, "back")
    jax_dist, _, _ = _depth_plane_distance(t, np.asarray(j.rows), sel)
    print(f"depth plane vs float64 over {n} pixel centres of {sel.sum()} "
          f"triangles (|zx px| <= {zxp:.3g}): port {port:.3e}, JAX package "
          f"{jax_dist:.3e}")
    return port, jax_dist, n, int(sel.sum())


def test_depth_plane_witness_small_triangles_far_from_the_origin():
    """At 1920x1080, on a sphere's triangles of 1-32 px^2 of doubled area
    in the frame's far quarter at 6-11 units (the high-poly scene's
    depths), the port's depth plane is within 1e-5 relative of the plane
    through its corners in float64 at every covered pixel centre. The
    setup anchors the depth constant at a corner and weighs the depth
    differences; the JAX package, whose constant sums absolute-coordinate
    cross products, reads ~0.1 there (recorded, not asserted)."""
    port, jax_dist, n, count = _witness(
        *_far_sphere_triangles(1920, 1080),
        lambda area, side: (area >= 1.0) & (area <= 32.0))
    assert count > 5000 and n > 50000
    assert port <= 1e-5, (port, jax_dist)


def _far_slivers(W: int, H: int, n: int = 400, seed: int = 7):
    """Clip-space corners of ``n`` long thin triangles (both windings) at
    6-11 units from the eye under ``_far_sphere_triangles``'s camera, each
    centred in the frame's far quarter: a side of about 250-500 px, a
    width of 0.3-3 px."""
    from tinyrenderer_tpu_torch.scene.camera import Camera
    cam = Camera.new_default(W, H)
    cam.aspect = W / H
    cam.position = np.zeros(3, np.float32)
    cam.look_at(np.array([1.0, 0.0, 0.0], np.float32))
    vp = (cam.proj_matrix() @ cam.view_matrix()).astype(np.float32)
    rng = np.random.default_rng(seed)
    d = rng.uniform(6.0, 11.0, n)
    mid = np.stack([d, d * rng.uniform(-0.33, -0.27, n),
                    d * rng.uniform(0.5, 0.6, n)], 1)
    ang = rng.uniform(0.0, 2 * np.pi, n)
    along = np.stack([rng.uniform(-0.3, 0.3, n), np.cos(ang), np.sin(ang)], 1)
    across = np.stack([np.zeros(n), -np.sin(ang), np.cos(ang)], 1)
    length = rng.uniform(0.3, 0.54, n) * d
    p0 = mid - along * (length / 2)[:, None]
    p1 = p0 + along * length[:, None]
    p2 = (p0 + along * (length * rng.uniform(0.2, 0.8, n))[:, None]
          + across * (rng.uniform(0.3, 3.0, n) * d / 1069)[:, None])
    pos = np.concatenate([p0, p1, p2]).astype(np.float32)
    clip = (np.c_[pos, np.ones(len(pos), np.float32)] @ vp.T).astype(np.float32)
    k = np.arange(n, dtype=np.int32)
    vidx = np.stack([k, k + n, k + 2 * n], 1)
    return clip, np.concatenate([vidx, vidx[:, [0, 2, 1]]])


def test_depth_plane_witness_slivers_far_from_the_origin():
    """As the small triangles' witness, on slivers in the frame's far
    quarter: a bounding box of 300-400 px and a doubled area of 100-1000
    px^2, where a constant of cross products of absolute coordinates
    cancels as much as on the small triangles, and a plane solved from
    corner offsets is worst conditioned."""
    port, jax_dist, n, count = _witness(
        *_far_slivers(1920, 1080),
        lambda area, side: ((area >= 100.0) & (area <= 1000.0)
                            & (side >= 300.0) & (side <= 400.0)))
    assert count > 50 and n > 5000
    assert port <= 1e-5, (port, jax_dist)

"""The parity decision for what the raster setup's plane constants feed.

The JAX package forms the edge constants and the depth plane of a
triangle's setup from absolute-coordinate cross products, which cancel for
triangles small beside their distance from the origin; the port's
``ops/raster.py::triangle_setup`` forms them around a corner of every
triangle instead (the depth slopes solved from the corners' offsets).
Everything upstream of them (the screen corners, ``1/w``, the NDC depths,
``valid``, the bounding boxes, the edge slopes) stays bit-equal to the JAX
package; what they feed (rows, depth, ids, frames) does not. A test of
such an output renders the port three ways:

- under :func:`jax_planes`, the port with :func:`jax_setup`, a setup that
  rounds the planes as the JAX package does: the test's original check
  against the JAX package holds unchanged, so the rest of the port is held
  bit for bit;
- as it is;
- under :func:`float64_planes`, the planes through the same float32
  corners evaluated in float64 and rounded once: the yardstick.

:func:`assert_nearer` then holds the port's own output to the yardstick
no worse than the JAX package's output is held: coverage (ids) that
differs from the yardstick's at no more pixels, depth no farther from it
(or, where both agree with it to rounding, within the depth-plane
witnesses' ``PLANE_REL``). :func:`hold_frame` adds the edge-aware
comparator on the port's own tone-mapped frame and its monitors.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from tinyrenderer_tpu_torch.ops import raster
from tinyrenderer_tpu_torch.ops.fp import fma, fma_chain

PORT_SETUP = raster.triangle_setup
# the setup row's columns the plane constants and depth slopes fill
_PLANE_COLS = [2, 5, 8, 9, 10, 11]


def jax_setup(clip, tri_vidx, tri_mask, width, height, cull="back"):
    """The port's setup with its plane constants and depth slopes rounded
    as the JAX package's compiled setup rounds them: the edge constants
    from the cross products ``x_a*y_b - x_b*y_a`` over the doubled area,
    the depth slopes and constant summed over the corner depths. The
    columns upstream of them are the port's (bit-equal to the JAX
    package's); the corner differences are recomputed as it rounds
    them."""
    s = PORT_SETUP(clip, tri_vidx, tri_mask, width, height, cull)
    cs = [clip[tri_vidx.long()[:, k]] for k in range(3)]
    iws = s.inv_w.unbind(1)
    vx = [c[:, 0] * iw * 0.5 + 0.5 for c, iw in zip(cs, iws)]
    vy = [0.5 - c[:, 1] * iw * 0.5 for c, iw in zip(cs, iws)]
    (x0, x1, x2), (y0, y1, y2) = (s.screen[..., 0].unbind(1),
                                  s.screen[..., 1].unbind(1))
    zs = s.z_ndc.unbind(1)
    w, h = clip.new_full((), float(width)), clip.new_full((), float(height))
    dx10, dx20 = fma(vx[1], w, -x0), fma(vx[2], w, -x0)
    dy20, dy10 = fma(vy[2], h, -y0), fma(vy[1], h, -y0)
    dx21z, dy12z = fma(-vx[1], w, x2), fma(-vy[2], h, y1)
    area2 = fma(dx10, dy20, -(dx20 * dy10))
    big = area2.abs() > 1e-12
    inv_area = 1.0 / torch.where(big, area2, torch.ones_like(area2))
    r = s.rows
    e1x, e1y, e2x, e2y = r[:, 3], r[:, 4], r[:, 6], r[:, 7]
    e0c = fma(x1, y2, -(x2 * y1)) * inv_area
    e1c = fma(x2, y0, -(x0 * y2)) * inv_area
    e2c = fma(x0, y1, -(x1 * y0)) * inv_area
    zx = fma_chain([(dy12z * inv_area, zs[0]), (e1x, zs[1]), (e2x, zs[2])])
    zy = raster.affine3(dx21z * inv_area, zs[0], e1y, zs[1], e2y, zs[2])
    zc = fma_chain([(e0c, zs[0]), (e1c, zs[1]), (e2c, zs[2])])
    cols = torch.stack([e0c, e1c, e2c, zx, zy, zc], 1)
    rows = r.clone()
    rows[:, _PLANE_COLS] = torch.where(s.valid[:, None], cols,
                                       torch.zeros_like(cols))
    s.rows = rows
    return s


def float64_rows(s) -> torch.Tensor:
    """A setup's rows with its three edge planes and its depth plane
    through its float32 screen corners and NDC depths, evaluated in
    float64 and rounded once (the other columns as they are)."""
    p = s.screen.double()
    z = s.z_ndc.double()
    (x0, x1, x2), (y0, y1, y2) = p[..., 0].unbind(1), p[..., 1].unbind(1)
    area = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)
    area = torch.where(area != 0, area, torch.ones_like(area))
    edges = [((y1 - y2), (x2 - x1), (x1 * y2 - x2 * y1)),
             ((y2 - y0), (x0 - x2), (x2 * y0 - x0 * y2)),
             ((y0 - y1), (x1 - x0), (x0 * y1 - x1 * y0))]
    cols = [c / area for e in edges for c in e]
    cols += [sum(edges[k][j] / area * z[:, k] for k in range(3))
             for j in range(3)]
    rows = s.rows.clone()
    planes = torch.stack(cols, 1).float()
    rows[:, :12] = torch.where(s.valid[:, None], planes,
                               torch.zeros_like(planes))
    return rows


def float64_setup(clip, tri_vidx, tri_mask, width, height, cull="back"):
    """The port's setup with :func:`float64_rows`."""
    s = PORT_SETUP(clip, tri_vidx, tri_mask, width, height, cull)
    s.rows = float64_rows(s)
    return s


@contextlib.contextmanager
def _setup(fn):
    raster.triangle_setup = fn
    try:
        yield
    finally:
        raster.triangle_setup = PORT_SETUP


def jax_planes():
    """The port's frames under the JAX package's rounding of the planes."""
    return _setup(jax_setup)


def float64_planes():
    """The port's frames under the float64 planes."""
    return _setup(float64_setup)


def plane_distance(rows, rows64, screen, valid, width: int,
                   height: int) -> float:
    """The largest difference between the planes of ``rows`` and of
    ``rows64`` over the valid triangles, at the frame's pixel centres that
    each covers (at most 32 x 32 of them a triangle, evenly strided): the
    edge planes' absolute difference and the depth plane's relative
    one."""
    worst = 0.0
    for t in torch.nonzero(valid).flatten().tolist():
        sx, sy = screen[t, :, 0].double(), screen[t, :, 1].double()
        x0, x1 = max(0.0, float(sx.min())), min(float(width), float(sx.max()))
        y0, y1 = max(0.0, float(sy.min())), min(float(height), float(sy.max()))
        if x1 <= x0 or y1 <= y0:
            continue
        px = torch.arange(np.floor(x0), np.ceil(x1), max(1.0, np.ceil((x1 - x0) / 32)),
                          dtype=torch.float64) + 0.5
        py = torch.arange(np.floor(y0), np.ceil(y1), max(1.0, np.ceil((y1 - y0) / 32)),
                          dtype=torch.float64) + 0.5
        gx, gy = torch.meshgrid(px, py, indexing="xy")
        gx, gy = gx.reshape(-1), gy.reshape(-1)
        b = rows64[t].double()
        lam = [b[k] * gx + b[k + 1] * gy + b[k + 2] for k in (0, 3, 6)]
        inside = (lam[0] >= 0) & (lam[1] >= 0) & (lam[2] >= 0)
        if not inside.any():
            continue
        gx, gy = gx[inside], gy[inside]
        a = rows[t].double()
        for lo in (0, 3, 6, 9):
            va = a[lo] * gx + a[lo + 1] * gy + a[lo + 2]
            vb = b[lo] * gx + b[lo + 1] * gy + b[lo + 2]
            d = (va - vb).abs()
            if lo == 9:
                d = d / vb.abs().clamp(min=1e-30)
            worst = max(worst, float(d.max()))
    return worst


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


# The port's depth plane's accuracy, relative, as the depth-plane witnesses
# of tests/test_torch_raster.py assert it on small triangles and slivers far
# from the origin
PLANE_REL = 1e-5


def distances(port: dict, jax: dict, f64: dict, ids: str | None = "pick_id",
              depth: str = "depth") -> dict:
    """The port's and the JAX package's distances from the float64 planes'
    output (dicts of arrays of one shape each), as ``(port, jax)``:

    - ``coverage``: the pixels whose id (``ids``; with ``ids`` None,
      whether the depth is not 0) differs from the float64 planes' one;
    - ``depth``: the largest relative depth difference over the pixels
      where all three show the same id (or all cover) and the float64
      depth is not 0."""
    pz, jz, fz = (_host(d[depth]).astype(np.float64) for d in (port, jax, f64))
    assert pz.shape == jz.shape == fz.shape
    assert np.isfinite(pz).all() and np.isfinite(jz).all()
    if ids is None:
        pi, ji, fi = pz != 0, jz != 0, fz != 0
    else:
        pi, ji, fi = (_host(d[ids]) for d in (port, jax, f64))
    same = (pi == fi) & (ji == fi) & (fz != 0)
    assert same.any()

    def rel(z):
        return float((np.abs(z - fz)[same] / np.abs(fz[same])).max())
    return {"coverage": (int((pi != fi).sum()), int((ji != fi).sum())),
            "depth": (rel(pz), rel(jz))}


def assert_nearer(port: dict, jax: dict, f64: dict, ids: str | None = "pick_id",
                  depth: str = "depth") -> dict:
    """Hold ``port``'s outputs to ``jax``'s with the float64 planes'
    ``f64`` as the yardstick (:func:`distances`): the port's coverage
    differs from the yardstick's at no more pixels than the JAX
    package's, and its depth is no farther from it than the JAX
    package's, or than ``PLANE_REL`` where the JAX package's is nearer
    (both planes then agree with the yardstick to rounding, and which of
    them rounds nearer is chance). Returns the distances."""
    got = distances(port, jax, f64, ids, depth)
    (c_port, c_jax), (d_port, d_jax) = got["coverage"], got["depth"]
    assert c_port <= c_jax, ("coverage", c_port, c_jax)
    assert d_port <= max(d_jax, PLANE_REL), ("depth", d_port, d_jax)
    return got


def assert_sdr(sdr, *others: dict) -> None:
    """A tone-mapped frame (or a batch of them) passes the repository's
    edge-aware comparator against each of ``others`` (dicts with ``sdr``
    and ``pick_id``)."""
    from tinyrenderer_tpu_torch.utils import verify
    sdr = _host(sdr)
    one = sdr.ndim == 3
    for other in others:
        o_sdr, o_pick = _host(other["sdr"]), _host(other["pick_id"])
        for a, b, pick in (((sdr, o_sdr, o_pick),) if one
                           else zip(sdr, o_sdr, o_pick)):
            res = verify.edge_aware_compare(a, b, pick=pick)
            assert res["status"] == "pass", res


def hold_frame(port, jax, f64, monitors=()) -> dict:
    """The parity decision for a frame (port or JAX ``FrameOutput``s):
    :func:`assert_nearer` on the pick ids and depth; the port's own
    tone-mapped frame passes the repository's edge-aware comparator
    against the JAX frame and against the float64 planes' frame; the
    ``monitors`` named equal the JAX frame's."""
    got = assert_nearer(frame_fields(port), frame_fields(jax),
                        frame_fields(f64))
    assert_sdr(port.sdr, frame_fields(jax), frame_fields(f64))
    for m in monitors:
        assert (_host(getattr(port, m)).tolist()
                == _host(getattr(jax, m)).tolist()), m
    return got


def rerun(engine, delta_seconds: float = 0.0):
    """An engine's next frame with its shadow atlas rendered again (a
    cached atlas keeps the planes it was rendered under)."""
    engine._atlas = None
    return engine.run_frame(delta_seconds)


def beside(render) -> tuple:
    """``render()``'s port output under the JAX package's rounding of the
    planes and under the float64 planes."""
    with jax_planes():
        under_jax = render()
    with float64_planes():
        f64 = render()
    return under_jax, f64


def three(render) -> tuple:
    """``render()``'s port output under the JAX package's rounding of the
    planes, as it is, and under the float64 planes."""
    under_jax, f64 = beside(render)
    return under_jax, render(), f64


def frame_fields(out, names=("pick_id", "depth", "sdr")) -> dict:
    """The named outputs of a frame (a port or JAX ``FrameOutput``)."""
    return {k: _host(getattr(out, k)) for k in names}


FORMS = ("jax", "port", "float64")


def sharded_frame_job(rank: int, world: int, job: dict) -> list:
    """``parallel.jobs.frame_job`` on a rank, its cases run under the JAX
    package's rounding of the planes, as they are and under the float64
    planes, one after the other (``FORMS``): a list of three case lists'
    concatenation."""
    from tinyrenderer_tpu_torch.parallel import jobs
    with jax_planes():
        under_jax = jobs.frame_job(rank, world, job)
    port = jobs.frame_job(rank, world, job)
    with float64_planes():
        f64 = jobs.frame_job(rank, world, job)
    return under_jax + port + f64

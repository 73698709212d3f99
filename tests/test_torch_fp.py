"""``ops/fp.py`` on the CPU: the fused multiply-adds' plain versions at the
call sites that now take the chain helper, the packing of
``csrc/fp.cu``'s operands, the dispatch a CUDA tensor takes (run here
through an emulation of the kernel on the packed operands), what raises,
and the host's exact check that proves a kernel value correctly rounded.
The kernels themselves run on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py`` phase 15)."""

import ctypes
import math
import os
from fractions import Fraction

import numpy as np
import pytest
import torch

from tinyrenderer_tpu_torch import kernels
from tinyrenderer_tpu_torch.ops import fp, post, raster, resolve, shading
from tinyrenderer_tpu_torch.render import compiled

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32, BF16, F16 = torch.float32, torch.bfloat16, torch.float16


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Six test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand(rng, *shape, dtype=F32, scale=1.0):
    x = torch.from_numpy((rng.standard_normal(shape) * scale)
                         .astype(np.float32))
    return x.to(dtype)


def _same(x, y):
    assert x.dtype == y.dtype and x.shape == y.shape
    assert torch.equal(x.view(torch.int32) if x.dtype == F32 else x,
                       y.view(torch.int32) if y.dtype == F32 else y)


# ---- the rewritten call sites, bit-equal to their nested forms --------------

def _site_affine3_columns(rng):
    m, p = _rand(rng, 50, 16), _rand(rng, 50, 3)
    px, py, pz = p[:, 0], p[:, 1], p[:, 2]
    i = 1
    got = raster.affine3(m[:, 4 * i], px, m[:, 4 * i + 1], py,
                         m[:, 4 * i + 2], pz, m[:, 4 * i + 3])
    old = fp.fma(m[:, 4 * i + 2], pz, fp.fma(m[:, 4 * i], px,
                                             m[:, 4 * i + 1] * py)) \
        + m[:, 4 * i + 3]
    return got, old


def _site_affine3_scalars(rng):
    vp, w = _rand(rng, 4, 4), _rand(rng, 64, 3, scale=5.0)
    wx, wy, wz = w.unbind(1)
    got = raster.affine3(vp[2, 0], wx, vp[2, 1], wy, vp[2, 2], wz, vp[2, 3])
    old = fp.fma(vp[2, 2], wz, fp.fma(vp[2, 0], wx, vp[2, 1] * wy)) + vp[2, 3]
    return got, old


def _site_affine3_no_tail(rng):
    nm, v = _rand(rng, 40, 9), _rand(rng, 40, 3)
    vx, vy, vz = v[:, 0], v[:, 1], v[:, 2]
    got = raster.affine3(nm[:, 3], vx, nm[:, 4], vy, nm[:, 5], vz)
    old = fp.fma(nm[:, 5], vz, fp.fma(nm[:, 3], vx, nm[:, 4] * vy))
    return got, old


def _site_setup_depth_planes(rng):
    e = [_rand(rng, 70) for _ in range(6)]
    zs = [_rand(rng, 70) for _ in range(3)]
    got = torch.stack([
        fp.fma_chain([(e[0], zs[0]), (e[1], zs[1]), (e[2], zs[2])]),
        fp.fma_chain([(e[3], zs[0]), (e[4], zs[1]), (e[5], zs[2])])])
    old = torch.stack([fp.fma(e[2], zs[2], fp.fma(e[1], zs[1], e[0] * zs[0])),
                       fp.fma(e[5], zs[2], fp.fma(e[4], zs[1], e[3] * zs[0]))])
    return got, old


def _site_shading_dot(rng):
    a, b = _rand(rng, 6, 8, 3), _rand(rng, 3)     # b broadcast
    got = torch.cat([shading._dot(a, b), shading._normalize(a)], -1)
    old_dot = fp.fma(a[..., 2:3], b[..., 2:3], fp.fma(
        a[..., 1:2], b[..., 1:2], a[..., 0:1] * b[..., 0:1]))
    aa = fp.fma(a[..., 2:3], a[..., 2:3], fp.fma(
        a[..., 1:2], a[..., 1:2], a[..., 0:1] * a[..., 0:1]))
    old = torch.cat([old_dot, a / fp.sqrt(aa).clamp(min=1e-12)], -1)
    return got, old


def _site_shading_dot3(rng):
    v = [_rand(rng, 5, 7) for _ in range(6)]
    got = torch.stack([shading._dot3(*v), *shading._norm3(*v[:3])])
    x, y, z = v[:3]
    d = fp.sqrt(fp.fma(z, z, fp.fma(x, x, y * y))).clamp(min=1e-12)
    old = torch.stack([fp.fma(v[2], v[5], fp.fma(v[0], v[3], v[1] * v[4])),
                       x / d, y / d, z / d])
    return got, old


def _site_safe_normalize(rng):
    v = _rand(rng, 4, 9, 3)
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    n = fp.sqrt(fp.fma(z, z, fp.fma(y, y, x * x))).clamp(min=1e-12)
    return resolve._safe_normalize(v), v / n[..., None]


def _site_normal_map(rng):
    nt = _rand(rng, 4, 9, 3)
    t, bt = _rand(rng, 4, 9, 3), _rand(rng, 4, 9, 3, dtype=BF16)
    n = _rand(rng, 4, 9, 3, dtype=BF16)
    got = fp.fma_chain([(nt[..., 1:2], bt), (nt[..., 0:1], t),
                        (nt[..., 2:3], n)])
    old = fp.fma(nt[..., 2:3], n, fp.fma(nt[..., 0:1], t, nt[..., 1:2] * bt))
    return got, old


def _old_project(position, refl, ts, vp):
    p = fp.fma(refl, ts[..., None], position)
    px, py, pz = p[..., 0], p[..., 1], p[..., 2]
    c = [fp.fma(pz, vp[i, 2], fp.fma(py, vp[i, 1], px * vp[i, 0])) + vp[i, 3]
         for i in range(4)]
    w = c[3].clamp(min=1e-6)
    return (c[0] / w) * 0.5 + 0.5, 0.5 - (c[1] / w) * 0.5, c[2] / w


def _site_ssr_project(rng):
    position, refl = _rand(rng, 6, 10, 3, scale=4), _rand(rng, 6, 10, 3)
    ts, vp = _rand(rng, 6, 10).abs(), _rand(rng, 4, 4)
    got = torch.stack(post._project_ray_points(position, refl, ts, vp))
    return got, torch.stack(_old_project(position, refl, ts, vp))


def _site_ssr_view(rng):
    view, normal = _rand(rng, 6, 10, 3), _rand(rng, 6, 10, 3)
    vx, vy, vz = view[..., 0], view[..., 1], view[..., 2]
    nx, ny, nz = normal[..., 0], normal[..., 1], normal[..., 2]
    got = torch.stack([
        fp.fma_chain([(vy, vy), (vx, vx), (vz, vz)], root=True),
        fp.fma_chain([(vy, ny), (vx, nx), (vz, nz)])])
    old = torch.stack([fp.sqrt(fp.fma(vz, vz, fp.fma(vx, vx, vy * vy))),
                       fp.fma(vz, nz, fp.fma(vx, nx, vy * ny))])
    return got, old


def _site_forward_ndotl(rng):
    normal, d = _rand(rng, 6, 10, 3), _rand(rng, 3)
    nx, ny, nz = normal[..., 0], normal[..., 1], normal[..., 2]
    got = -fp.fma_chain([(nx, d[0]), (ny, d[1]), (nz, d[2])])
    old = -fp.fma(nz, d[2], fp.fma(ny, d[1], nx * d[0]))
    return got, old


def _site_plane(rng):
    a, b, c = _rand(rng, 3, 1, 1), _rand(rng, 3, 1, 1), _rand(rng, 3, 1, 1)
    px, py = _rand(rng, 1, 4, 8, scale=100), _rand(rng, 1, 4, 8, scale=100)
    got = torch.stack([fp.plane(a, b, c, px, py),
                       fp.plane(a, b, c, px, py, mxu_order=True)])
    old = torch.stack([fp.fma(a, px, b * py) + c,
                       fp.fma(b, py, a * px) + c])
    return got, old


SITES = {f.__name__[6:]: f for f in (
    _site_affine3_columns, _site_affine3_scalars, _site_affine3_no_tail,
    _site_setup_depth_planes, _site_shading_dot, _site_shading_dot3,
    _site_safe_normalize, _site_normal_map, _site_ssr_project,
    _site_ssr_view, _site_forward_ndotl, _site_plane)}


@pytest.mark.parametrize("site", list(SITES))
def test_chain_sites_equal_their_nested_forms(site):
    """Each call site rewritten to ``fp.fma_chain`` (and ``raster.affine3``,
    ``fp.plane``) gives, bit for bit, the nested ``fma`` form it replaced,
    in that site's term order, on random float32 inputs with broadcast,
    0-dim, strided and bfloat16 operands."""
    got, old = SITES[site](np.random.default_rng(len(site)))
    _same(got, old)


# ---- the packing ----------------------------------------------------------------

def _storage(t):
    """t's whole storage as a flat float32 numpy array."""
    flat = torch.empty(0, dtype=t.dtype).set_(t.untyped_storage())
    return flat.float().numpy()


def _gather(t, dims, strides):
    """t's elements at the packed element offsets, row-major over dims."""
    idx = np.indices(dims).reshape(len(dims), -1)
    off = t.storage_offset() + (np.asarray(strides)[:, None] * idx).sum(0)
    return _storage(t)[off]


def _operand_sets(rng):
    base = _rand(rng, 6, 5, 4)
    big = _rand(rng, 7, 16)
    return {
        "contiguous": {0: _rand(rng, 6, 5, 4), 1: _rand(rng, 6, 5, 4),
                       6: _rand(rng, 6, 5, 4)},
        "broadcast": {0: _rand(rng, 6, 1, 4), 1: _rand(rng, 5, 1),
                      6: _rand(rng, 4), 7: torch.tensor(0.25)},
        "columns": {0: big[:, 4], 1: big[:, 5], 2: big[:, 6],
                    3: _rand(rng, 7), 6: big[2, 3]},
        "transposed": {0: base.transpose(0, 2), 1: base.permute(2, 0, 1)
                       .contiguous().permute(0, 2, 1), 6: torch.tensor(2.0)},
        "expanded": {0: _rand(rng, 1, 5, 1).expand(6, 5, 4),
                     1: _rand(rng, 6, 10, 4)[:, ::2],
                     2: _rand(rng, 12, 5, 6)[::2, :, 1:5],
                     3: _rand(rng, 5, 1, dtype=BF16), 6: torch.tensor(
                         -1.5, dtype=F16)},
        "narrow": {0: _rand(rng, 2, 3, 5, dtype=F16)[..., 1:4],
                   1: _rand(rng, 3, 1, dtype=BF16), 6: _rand(rng, 2, 1, 1)},
        "scalar out": {0: torch.tensor(3.0), 1: _rand(rng, 1, 1), 6: _rand(
            rng, 1)},
    }


@pytest.mark.parametrize("case", ["contiguous", "broadcast", "columns",
                                  "transposed", "expanded", "narrow",
                                  "scalar out"])
def test_pack_addresses_the_broadcast_elements(case):
    """``fp.pack`` is a pure function of its operands' metadata: over its
    merged dimensions, each operand read in place (here: a ``meta`` tensor
    standing in for the device's, with the same shape, strides and dtype)
    addresses exactly the elements ``torch.broadcast_tensors`` gives, and a
    0-dim CPU operand beside them goes by value."""
    slots = _operand_sets(np.random.default_rng(7))[case]
    # 0-dim operands stay on the CPU (by value); the rest are "device" ones
    dev = {s: torch.empty_strided(t.shape, t.stride(), dtype=t.dtype,
                                  device="meta") if t.dim() else t
           for s, t in slots.items()}
    p = fp.pack(dev, device_type="meta")
    want = torch.broadcast_tensors(*(t.float() for t in slots.values()))
    assert p.shape == tuple(want[0].shape)
    assert math.prod(p.dims) == max(1, want[0].numel())
    assert len(p.dims) <= kernels.FP_DIMS
    for s, w in zip(slots, want):
        w = w.reshape(-1).numpy()
        if s in p.values:
            assert slots[s].dim() == 0 and s not in p.tensors
            np.testing.assert_array_equal(np.full_like(w, p.values[s]), w)
        else:
            assert p.tensors[s] is dev[s]
            got = _gather(slots[s], p.dims, p.strides[s])
            np.testing.assert_array_equal(got, w)


def test_pack_merges_contiguous_dimensions():
    """Operands contiguous across the output's dimensions reach the kernel
    as one dimension (its vector path); a column slice keeps its stride."""
    x = torch.empty((4, 5, 6), device="meta")
    assert fp.pack({0: x, 1: x, 6: torch.tensor(1.0)}, "meta").dims == (120,)
    m = torch.empty((100, 16), device="meta")
    p = fp.pack({0: m[:, 3], 1: torch.empty(100, device="meta")}, "meta")
    assert p.dims == (100,) and p.strides == {0: (16,), 1: (1,)}
    p = fp.pack({0: torch.empty((1, 7), device="meta"),
                 1: torch.empty((3, 7), device="meta")}, "meta")
    assert p.dims == (3, 7) and p.strides == {0: (0, 1), 1: (7, 1)}


@pytest.mark.parametrize("bad", ["float64", "int32", "bool", "cpu beside",
                                 "seven dims", "not a tensor"])
def test_operands_the_kernel_does_not_take_raise(bad):
    """Float64, integer and boolean operands, a CPU tensor with elements
    beside the device's, more dimensions than the kernel takes after
    merging, and a Python number raise (there is no float64 path on the
    device); nothing is built."""
    m = torch.empty((3, 4), device="meta")
    if bad == "seven dims":
        # no two neighbouring dimensions contiguous in both operands
        m = torch.empty((2,) * 7, device="meta").permute(6, 5, 4, 3, 2, 1, 0)
        x = torch.empty((2,) * 7, device="meta")
    else:
        x = {"float64": torch.empty((3, 4), dtype=torch.float64,
                                    device="meta"),
             "int32": torch.empty((3, 4), dtype=torch.int32, device="meta"),
             "bool": torch.empty((3, 4), dtype=torch.bool, device="meta"),
             "cpu beside": torch.ones((3, 4)),
             "not a tensor": 2.0}[bad]
    with pytest.raises((TypeError, ValueError)):
        fp.pack({0: m, 1: x, 6: m}, "meta")
    assert kernels._lib is None


# ---- the dispatch a CUDA tensor takes, emulated on the packed operands -----------

def _emulate(kind, slots, n_pairs=0, lerp=False, root=False):
    """csrc/fp.cu's arithmetic on ``fp.pack``'s view of CPU operands: each
    slot gathered at its packed offsets, then the chain in float32 with each
    fused step rounded from float64 (as the plain version rounds it)."""
    p = fp.pack(slots, device_type="cpu")
    v = {s: _gather(t, p.dims, p.strides[s]).astype(np.float64)
         for s, t in p.tensors.items()}
    n = math.prod(p.dims)
    v.update({s: np.full(n, x) for s, x in p.values.items()})
    f32 = np.float32
    if lerp:
        r = (v[0] * (f32(1.0) - v[2].astype(f32)).astype(np.float64)
             + (v[1].astype(f32) * v[2].astype(f32)).astype(np.float64))
        r = r.astype(f32)
    else:
        r = v[6].astype(f32) if 6 in v else (v[0] * v[1]).astype(f32)
        for k in range(0 if 6 in v else 1, n_pairs):
            r = (v[2 * k] * v[2 * k + 1] + r.astype(np.float64)).astype(f32)
        if 7 in v:
            r = r + v[7].astype(f32)
    if root:
        r = np.sqrt(r.astype(np.float64)).astype(f32)
    return torch.from_numpy(np.ascontiguousarray(r).reshape(p.shape))


@pytest.mark.parametrize("dtypes", [(F32, F32), (BF16, BF16), (F16, F32),
                                    (BF16, F16)])
def test_device_dispatch_equals_the_plain_version(monkeypatch, dtypes):
    """The steps a CUDA call takes (the slots, a leading product or a
    ``1 - f`` that the plain version rounds in a narrower type done in
    PyTorch first, a narrower tail added to a 0-dim chain last), run
    through an emulation of the kernel on the packed operands, equal each
    entry point's plain version."""
    rng = np.random.default_rng(11)
    ta, tb = dtypes
    a, b = _rand(rng, 5, 1, 3, dtype=ta), _rand(rng, 4, 3, dtype=tb)
    c, f = _rand(rng, 5, 4, 1, dtype=tb), _rand(rng, 4, 1, dtype=ta).abs()
    s0 = torch.tensor(0.75, dtype=ta)
    cases = [
        ("fma", lambda: fp.fma(a, b, c), lambda: fp.fma_ref(a, b, c)),
        ("lerp", lambda: fp.lerp(a, b, f), lambda: fp.lerp_ref(a, b, f)),
        ("sqrt", lambda: fp.sqrt(c.abs()), lambda: fp.sqrt_ref(c.abs())),
        ("plane", lambda: fp.plane(a, b, c, f, s0),
         lambda: fp.plane_ref(a, b, c, f, s0)),
        ("plane mxu", lambda: fp.plane(a, b, c, f, s0, True),
         lambda: fp.plane_ref(a, b, c, f, s0, True)),
        ("chain", lambda: fp.fma_chain([(a, b), (c, f), (s0, a)], d=c),
         lambda: fp.fma_chain_ref([(a, b), (c, f), (s0, a)], d=c)),
        ("chain addend root", lambda: fp.fma_chain(
            [(a, a), (b, b)], c=c.abs(), root=True),
         lambda: fp.fma_chain_ref([(a, a), (b, b)], c=c.abs(), root=True)),
        ("0-dim chain, tensor tail", lambda: fp.fma_chain(
            [(s0, s0)], d=b), lambda: fp.fma_chain_ref([(s0, s0)], d=b)),
    ]
    for name, dev, ref in cases:
        with monkeypatch.context() as mp:
            mp.setattr(fp, "_plain", lambda *ops: False)
            mp.setattr(fp, "_launch", _emulate)
            got = dev()
        _same(got, ref())


def test_cpu_tensors_take_the_plain_forms():
    """On CPU tensors every entry point returns its plain version's value
    and launches nothing; the float64 forms switch only routes device
    operands (``meta`` here) to the plain versions too, inside the
    context."""
    rng = np.random.default_rng(3)
    a, b, c = _rand(rng, 8, 3), _rand(rng, 3), _rand(rng, 8, 1)
    counts = compiled.launch_counts()
    _same(fp.fma(a, b, c), (a.double() * b.double() + c.double()).float())
    _same(fp.lerp(a, b, c), fp.fma_ref(a, 1.0 - c, b * c))
    _same(fp.sqrt(c.abs()), torch.sqrt(c.abs().double()).float())
    _same(fp.fma_chain([(a, b)], c=c, d=b), fp.fma_ref(a, b, c) + b)
    assert compiled.launch_counts() == counts and kernels._lib is None
    for bad in ([(a, b)] * 4, []):      # one to three pairs, or an addend
        with pytest.raises(ValueError):
            fp.fma_chain(bad)
    m = torch.empty((4, 3), device="meta")
    with pytest.raises(ValueError):
        fp.fma(m, m, torch.ones(4, 3))
    with fp.float64_forms():
        out = fp.fma_chain([(m, m), (m, m)], d=m, root=True)
        assert out.device.type == "meta" and out.dtype == F32
    with pytest.raises(ValueError):
        fp.fma(m, m, torch.ones(4, 3))


def test_kernel_sources_signatures_and_counters():
    """csrc/fp.cu is built with the other sources, its five entry points
    and the descriptor's size are bound, the descriptor's ctypes mirror
    has the C layout (656 bytes, operands of 64), and each entry point's
    launch counter is one of the compiled frame's."""
    assert "fp.cu" in kernels.SOURCES and (kernels.CSRC / "fp.cu").exists()
    names = ("tr_fp_fma", "tr_fp_lerp", "tr_fp_plane", "tr_fp_sqrt",
             "tr_fp_chain")
    for n in names:
        assert kernels.SIGNATURES[n] == (kernels.FpArgs, ctypes.c_void_p,
                                         ctypes.c_void_p)
    assert kernels.SIGNATURES["tr_fp_args_bytes"] == ()
    assert ctypes.sizeof(kernels.FpOperand) == 64
    assert ctypes.sizeof(kernels.FpArgs) == 656
    assert kernels.FpArgs.op.offset == 0 and kernels.FpArgs.n.offset == 560
    src = (kernels.CSRC / "fp.cu").read_text()
    assert '#define TR_FP_ENTRY(entry, kernel)' in src
    assert 'extern "C" int entry(FpArgs args, void* out, void* stream)' in src
    for n in names:
        assert f"TR_FP_ENTRY({n}, fp_{n[6:]}_kernel)" in src
    assert "TR_FP_DIMS 6" in src and "TR_FP_SLOTS 8" in src
    keys = {k for k, _, _ in compiled._COUNTERS}
    assert {"fp.fma", "fp.lerp", "fp.plane", "fp.sqrt",
            "fp.fma_chain"} <= keys
    assert set(fp._COUNTER.values()) == {
        name for _, mod, name in compiled._COUNTERS if mod is fp}


# ---- the host's exact check ------------------------------------------------------

def test_round_f32_is_the_nearest_float32():
    """``round_f32`` on rationals equals numpy's float32 rounding of
    doubles (which is exact for a double), at subnormals, ties and the
    overflow threshold too."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal(3000) * np.exp2(rng.integers(-160, 130, 3000))
    with np.errstate(over="ignore"):
        want = x.astype(np.float32).astype(np.float64)
    for v, w in zip(x, want):
        assert fp.round_f32(Fraction(float(v))) == w
    tiny = Fraction(1, 2 ** 149)
    assert fp.round_f32(tiny / 2) == 0.0                 # tie to even: 0
    assert fp.round_f32(tiny * 3 / 2) == float(tiny * 2)
    top = Fraction(2 ** 128 - 2 ** 104)                   # largest float32
    assert fp.round_f32(top + 2 ** 102) == float(top)
    assert fp.round_f32(top + 2 ** 103) == math.inf       # tie to even: up


def test_exact_chain_proves_the_true_fused_multiply_add():
    """Where the float64 form rounds twice, the exact check gives the true
    fused multiply-add: ``(1 + 2^-23) + 2^-24 (1 + 2^-23)(1 - 2^-23)`` lies
    just under a float32 halfway point, which the float64 sum lands on.
    On random inputs both agree."""
    a = np.float32(2.0 ** -24 * (1 + 2.0 ** -23))
    b = np.float32(1 - 2.0 ** -23)
    c = np.float32(1 + 2.0 ** -23)
    vals = {0: float(a), 1: float(b), 6: float(c)}
    exact = fp.exact_chain(vals, n_pairs=1)
    f64 = fp.fma_ref(*(torch.tensor([float(x)]) for x in (a, b, c))).item()
    assert exact == float(c) and f64 == 1 + 2.0 ** -22
    rng = np.random.default_rng(9)
    x = rng.standard_normal((500, 8)).astype(np.float32)
    for row in x:
        v = {s: float(row[s]) for s in range(8)}
        t = [torch.tensor([row[s]]) for s in range(8)]
        want = fp.fma_chain_ref([(t[0], t[1]), (t[2], t[3]), (t[4], t[5])],
                                d=t[7]).item()
        assert fp.exact_chain({k: v[k] for k in (0, 1, 2, 3, 4, 5, 7)},
                              n_pairs=3) == want
        want = fp.lerp_ref(t[0], t[1], t[2]).item()
        assert fp.exact_chain({0: v[0], 1: v[1], 2: v[2]}, lerp=True) == want
        want = fp.fma_chain_ref([], c=t[6].abs(), root=True).item()
        assert fp.exact_chain({6: abs(v[6])}, root=True) == want
    assert math.isnan(fp.exact_chain({0: math.inf, 1: 1.0, 6: 0.0}, 1))



def test_prove_mismatches_accepts_only_the_exact_value():
    """``prove_mismatches`` counts the elements where a kernel's output
    and the float64 form differ once each is proven exact, and raises on
    one that is not (here: the double-rounding input above, beside random
    elements both forms agree on, broadcast against a 0-dim addend).
    ``launch_ref`` is each launch's plain version."""
    rng = np.random.default_rng(2)
    a = _rand(rng, 16)
    b = _rand(rng, 16)
    a[5] = float(np.float32(2.0 ** -24 * (1 + 2.0 ** -23)))
    b[5] = float(np.float32(1 - 2.0 ** -23))
    c = torch.tensor(float(np.float32(1 + 2.0 ** -23)))
    slots = {0: a, 1: b, 6: c}
    ref = fp.launch_ref(slots, n_pairs=1)
    _same(ref, fp.fma_ref(a, b, c))
    true = ref.clone()
    true[5] = float(c)            # the true fused multiply-add's value
    assert fp.prove_mismatches(true, ref, slots, n_pairs=1) == 1
    assert fp.prove_mismatches(ref, ref, slots, n_pairs=1) == 0
    wrong = ref.clone()
    wrong[3] = torch.nextafter(wrong[3], torch.tensor(math.inf))
    with pytest.raises(AssertionError):
        fp.prove_mismatches(wrong, ref, slots, n_pairs=1)
    f = _rand(rng, 16).abs()
    _same(fp.launch_ref({0: a, 1: b, 2: f}, lerp=True), fp.lerp_ref(a, b, f))
    _same(fp.launch_ref({6: f}, root=True), fp.sqrt_ref(f))
    _same(fp.launch_ref({0: a, 1: b, 2: f, 3: a, 7: c}, n_pairs=2),
          fp.fma_ref(f, a, a * b) + c)

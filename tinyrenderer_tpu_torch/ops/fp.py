"""Fused multiply-adds with the reference's rounding: plain versions and
the glue kernels of ``csrc/fp.cu``.

The JAX reference's compiled elementwise loops are XLA's, whose LLVM
backend contracts ``a * b + c`` into one fused multiply-add (rounded
once). PyTorch rounds every operation. Where a result must be bit-equal to
the reference (raster depth and coverage, the select + eval planes, the
texture blend, the triangle setup, the G-buffer's dot products, SSR's ray
projection), the port spells the contraction out with :func:`fma`,
:func:`lerp`, :func:`plane` and :func:`fma_chain`, and the K1-K7 kernels use
``__fmaf_rn`` in the same places.

Each entry point takes the plain version (``*_ref``: the product and sum in
float64, rounded to float32) for CPU tensors, and for CUDA tensors launches
its kernel of ``csrc/fp.cu`` or raises:

- replaces: no Pallas kernel; XLA's contracted multiply-add in the JAX
  package's compiled elementwise loops;
- bound: bytes over 3.35 TB/s (each operand read once, 4 bytes an output
  element written; one to four operations an element);
- design: one chained kernel (``r = c`` or ``a0 * b0``, then
  ``fma(a_k, b_k, r)``, ``+ d``, an optional ``sqrtf``) reading every
  operand in place through element strides (:func:`pack`), the descriptor
  passed by value as the kernel's parameter, so a launch uploads nothing and
  can be captured into a CUDA graph.

The kernel is a true fused multiply-add; the float64 form differs from it
on about 2**-29 of random inputs (:func:`fma_ref`), where the kernel is the
one that matches the reference. :func:`float64_forms` routes CUDA tensors to
the plain versions too: a measurement switch for timing the float64 forms
beside the kernels, used by ``chip_smoke.py`` and by nothing on a frame
path.
"""

from __future__ import annotations

import contextlib
import ctypes
import math
import struct
from fractions import Fraction
from typing import NamedTuple, Optional, Sequence

import torch

from .. import kernels

F32 = torch.float32
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_C, _D = 6, 7                # the addend's and the tail's slots

FMA_LAUNCHES = 0     # CUDA launches of the fp kernels, one count an entry
LERP_LAUNCHES = 0
PLANE_LAUNCHES = 0
SQRT_LAUNCHES = 0
CHAIN_LAUNCHES = 0
_COUNTER = {"fma": "FMA_LAUNCHES", "lerp": "LERP_LAUNCHES",
            "plane": "PLANE_LAUNCHES", "sqrt": "SQRT_LAUNCHES",
            "chain": "CHAIN_LAUNCHES"}

_float64_forms = False
_layout_checked = [None]     # the library whose FpArgs size was checked


@contextlib.contextmanager
def float64_forms():
    """CUDA tensors take the plain float64 forms while the context is open.
    A measurement switch: a CUDA graph captured under it keeps the float64
    forms when it replays, so drop the compiled frames on entering and
    leaving (``render/reload.py invalidate_compiled_frames``)."""
    global _float64_forms
    old, _float64_forms = _float64_forms, True
    try:
        yield
    finally:
        _float64_forms = old


# ---- plain versions ---------------------------------------------------------

def fma_ref(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once.

    The float64 product of two float32 values is exact; the float64 sum is
    rounded to 53 bits before the float32 rounding, which differs from a
    true fused multiply-add only when that first rounding lands exactly on
    a float32 halfway point (about 2**-29 of random inputs)."""
    return (a.double() * b.double() + c.double()).float()


def lerp_ref(a: torch.Tensor, b: torch.Tensor,
             f: torch.Tensor) -> torch.Tensor:
    """``a * (1 - f) + b * f`` as the reference's CPU build rounds the
    bilinear blends: ``fma(a, 1 - f, b * f)``."""
    return fma_ref(a, 1.0 - f, b * f)


def sqrt_ref(x: torch.Tensor) -> torch.Tensor:
    """float32 square root rounded once, as XLA's CPU build and CUDA's
    ``sqrtf`` give it. PyTorch's vectorized CPU float32 sqrt is off by one
    ulp on ~0.7% of inputs; the float64 root rounded to float32 is exact
    (53 >= 2 * 24 + 2 bits, so the double rounding cannot bite)."""
    return torch.sqrt(x.double()).float()


def plane_ref(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
              px: torch.Tensor, py: torch.Tensor,
              mxu_order: bool = False) -> torch.Tensor:
    """Affine plane ``a * px + b * py + c`` with the reference's rounding.

    Broadcast multiply-adds (the VPU form): ``fma(a, px, b * py) + c``.
    The 3-term matrix product of large tiles (``mxu_order``):
    ``fma(b, py, a * px) + c``."""
    if mxu_order:
        return fma_ref(b, py, a * px) + c
    return fma_ref(a, px, b * py) + c


def fma_chain_ref(pairs: Sequence, c: Optional[torch.Tensor] = None,
                  d: Optional[torch.Tensor] = None,
                  root: bool = False) -> torch.Tensor:
    """The chain ``fma(a_n, b_n, ... fma(a_1, b_1, r0))``, each step rounded
    once: ``r0 = c`` when an addend is given (every pair is then a fused
    step), else ``a_0 * b_0``; then ``+ d`` when a tail is given, and the
    square root with ``root``. ``fma_chain([(x0, y0), (x1, y1), (x2, y2)])``
    is the nested ``fma(x2, y2, fma(x1, y1, x0 * y0))``."""
    pairs = list(pairs)
    if c is None:
        (a0, b0), pairs = pairs[0], pairs[1:]
        r = a0 * b0
    else:
        r = c
    for a, b in pairs:
        r = fma_ref(a, b, r)
    if d is not None:
        r = r + d
    return sqrt_ref(r) if root else r


# ---- entry points -----------------------------------------------------------

def _plain(*ops) -> bool:
    """The plain version serves the call: CPU operands, or the float64
    forms switched on."""
    return _float64_forms or all(t.device.type == "cpu" for t in ops
                                 if isinstance(t, torch.Tensor))


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once (:func:`fma_ref`)."""
    if _plain(a, b, c):
        return fma_ref(a, b, c)
    return _launch("fma", {0: a, 1: b, _C: c}, n_pairs=1)


def lerp(a: torch.Tensor, b: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """``fma(a, 1 - f, b * f)`` (:func:`lerp_ref`)."""
    if _plain(a, b, f):
        return lerp_ref(a, b, f)
    if f.dtype == F32 and torch.result_type(b, f) == F32:
        return _launch("lerp", {0: a, 1: b, 2: f}, lerp=True)
    # the plain version rounds 1 - f and b * f in a narrower type
    return _launch("lerp", {0: a, 1: 1.0 - f, _C: b * f}, n_pairs=1)


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """float32 square root rounded once (:func:`sqrt_ref`)."""
    if _plain(x):
        return sqrt_ref(x)
    return _launch("sqrt", {_C: x}, root=True)


def plane(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
          px: torch.Tensor, py: torch.Tensor,
          mxu_order: bool = False) -> torch.Tensor:
    """Affine plane ``a * px + b * py + c`` (:func:`plane_ref`)."""
    if _plain(a, b, c, px, py):
        return plane_ref(a, b, c, px, py, mxu_order)
    pairs = [(a, px), (b, py)] if mxu_order else [(b, py), (a, px)]
    return _chain("plane", pairs, None, c, False)


def fma_chain(pairs: Sequence, c: Optional[torch.Tensor] = None,
              d: Optional[torch.Tensor] = None,
              root: bool = False) -> torch.Tensor:
    """The chain of :func:`fma_chain_ref`: one to three pairs (none with
    an addend)."""
    pairs = list(pairs)
    if len(pairs) > 3 or not (pairs or c is not None):
        raise ValueError("fp.fma_chain: one to three pairs, or an addend")
    ops = [t for p in pairs for t in p] + [c, d]
    if _plain(*ops):
        return fma_chain_ref(pairs, c, d, root)
    return _chain("chain", pairs, c, d, root)


def _chain(kind: str, pairs: list, c, d, root: bool) -> torch.Tensor:
    """Launch a chain; the steps that the plain version rounds in a type
    other than float32 run in PyTorch as it runs them: a leading product
    of two narrower operands first, a narrower tail added to a 0-dim
    chain last."""
    if c is None and torch.result_type(*pairs[0]) != F32:
        (a0, b0), pairs = pairs[0], pairs[1:]
        c = a0 * b0
    slots = {2 * k + j: t for k, p in enumerate(pairs)
             for j, t in enumerate(p)}
    if c is not None:
        slots[_C] = c
    if d is not None and d.dtype != F32 and d.dim() > 0 and not \
            torch.broadcast_shapes(*(t.shape for t in slots.values())):
        out = _launch(kind, slots, n_pairs=len(pairs)) + d
        return sqrt(out) if root else out
    if d is not None:
        slots[_D] = d
    return _launch(kind, slots, n_pairs=len(pairs), root=root)


# ---- the launch -------------------------------------------------------------

class Packed(NamedTuple):
    """A launch's operands, as the kernel addresses them: the output's
    ``shape`` (the broadcast shape), its merged dimensions ``dims``; per
    slot, None (absent), a float (by value) or a tensor with its element
    ``strides`` over ``dims``."""
    shape: tuple
    dims: tuple
    tensors: dict       # slot -> tensor read in place
    strides: dict       # slot -> element strides over dims
    values: dict        # slot -> float passed by value


def pack(slots: dict, device_type: str = "cuda") -> Packed:
    """The kernel's view of ``slots`` (slot -> tensor), a pure function of
    their shapes, strides, dtypes and devices: broadcast to one shape,
    dimensions of size 1 dropped, neighbouring dimensions merged where
    every operand is contiguous across them. A tensor on ``device_type`` is
    read in place; a 0-dim CPU tensor beside them is passed by value, as
    PyTorch's elementwise ops pass it. Raises on a dtype other than
    float32, bfloat16 or float16, on a CPU tensor with elements beside a
    device's, on tensors of two devices and on more dimensions than
    ``kernels.FP_DIMS`` after merging."""
    tensors, values, device = {}, {}, None
    for s, t in slots.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"fp: operand {s} is a {type(t).__name__}, not "
                            f"a tensor")
        if t.dtype not in _DTYPES:
            raise TypeError(f"fp: operand {s} is {t.dtype}; the kernel reads "
                            f"float32, bfloat16 and float16")
        if t.device.type == device_type:
            if device is not None and t.device != device:
                raise ValueError(f"fp: operands on {device} and {t.device}")
            device, tensors[s] = t.device, t
        elif t.device.type == "cpu" and t.dim() == 0:
            values[s] = float(t.item())
        else:
            raise ValueError(f"fp: operand {s} lies on {t.device} with "
                             f"{t.numel()} elements beside {device_type} "
                             f"tensors")
    shape = tuple(torch.broadcast_shapes(*(t.shape for t in slots.values())))
    nd = len(shape)
    full = {}
    for s, t in tensors.items():
        pad = nd - t.dim()
        full[s] = [0] * pad + [0 if n == 1 else st for n, st in
                               zip(t.shape, t.stride())]
    dims, strides = [], {s: [] for s in tensors}
    for i, n in enumerate(shape):
        if n == 1:
            continue
        if dims and all(strides[s][-1] == full[s][i] * n for s in tensors):
            dims[-1] *= n
            for s in tensors:
                strides[s][-1] = full[s][i]
            continue
        dims.append(n)
        for s in tensors:
            strides[s].append(full[s][i])
    if not dims:
        dims = [1]
        strides = {s: [0] for s in tensors}
    if len(dims) > kernels.FP_DIMS:
        raise ValueError(f"fp: {len(dims)} dimensions after merging; the "
                         f"kernel takes {kernels.FP_DIMS}")
    return Packed(shape, tuple(dims), tensors,
                  {s: tuple(v) for s, v in strides.items()}, values)


def _launch(kind: str, slots: dict, n_pairs: int = 0, lerp: bool = False,
            root: bool = False) -> torch.Tensor:
    """Launch ``csrc/fp.cu``'s ``tr_fp_<kind>`` on ``slots`` (slot ->
    tensor); the float32 output is contiguous in the broadcast shape."""
    p = pack(slots)
    if not p.tensors:
        raise ValueError(f"fp.{kind}: no CUDA operand")
    dev = next(iter(p.tensors.values())).device
    out = torch.empty(p.shape, dtype=F32, device=dev)
    if out.numel() == 0:
        return out
    args = kernels.FpArgs()
    for s, t in p.tensors.items():
        o = args.op[s]
        o.ptr, o.dtype = t.data_ptr(), _DTYPES[t.dtype]
        o.stride[:len(p.dims)] = p.strides[s]
    for s, v in p.values.items():
        args.op[s].value = v
    args.shape[:len(p.dims)] = p.dims
    args.n, args.ndim, args.n_pairs = out.numel(), len(p.dims), n_pairs
    args.has_c, args.has_d = int(_C in slots), int(_D in slots)
    args.lerp, args.root = int(lerp), int(root)
    args.used = sum(1 << s for s in slots)
    lib = kernels.library()
    if lib is not _layout_checked[0]:
        if lib.tr_fp_args_bytes() != ctypes.sizeof(kernels.FpArgs):
            raise RuntimeError(
                f"csrc/fp.cu FpArgs is {lib.tr_fp_args_bytes()} bytes, its "
                f"ctypes mirror {ctypes.sizeof(kernels.FpArgs)}")
        _layout_checked[0] = lib
    code = getattr(lib, f"tr_fp_{kind}")(args, out.data_ptr(),
                                         kernels.stream_handle(dev))
    kernels.check(f"tr_fp_{kind}", code)
    globals()[_COUNTER[kind]] += 1
    return out


# ---- the host's exact check -------------------------------------------------

def round_f32(q: Fraction) -> float:
    """The float32 nearest to the rational ``q`` (ties to even; subnormals;
    beyond the largest float32, infinity), exactly."""
    if q == 0:
        return 0.0
    sign, q = (-1.0 if q < 0 else 1.0), abs(q)
    e = q.numerator.bit_length() - q.denominator.bit_length()
    if Fraction(2) ** e > q:
        e -= 1                                   # 2**e <= q < 2**(e + 1)
    ulp = Fraction(2) ** (max(e, -126) - 23)
    m, rem = divmod(q, ulp)
    if rem > ulp / 2 or (rem == ulp / 2 and m % 2):
        m += 1
    v = m * ulp
    if v >= 2 ** 128:
        return sign * math.inf
    return sign * float(v)


def exact_chain(values: dict, n_pairs: int = 0, lerp: bool = False,
                root: bool = False) -> float:
    """What ``csrc/fp.cu`` must give for one element: the chain of
    :func:`fma_chain_ref` on float32 ``values`` (slot -> float; slots as
    the kernel's) with every step rounded once, computed exactly in
    rationals; NaN where an operand or a step is not finite (no claim)."""
    if not all(math.isfinite(x) for x in values.values()):
        return math.nan
    v = {s: Fraction(x) for s, x in values.items()}

    def rnd(q: Fraction) -> Fraction:
        x = round_f32(q)
        if not math.isfinite(x):
            raise OverflowError
        return Fraction(x)

    try:
        if lerp:
            r = rnd(v[0] * rnd(1 - v[2]) + rnd(v[1] * v[2]))
        else:
            r = v[_C] if _C in v else rnd(v[0] * v[1])
            for k in range(0 if _C in v else 1, n_pairs):
                r = rnd(v[2 * k] * v[2 * k + 1] + r)
            if _D in v:
                r = rnd(r + v[_D])
    except OverflowError:
        return math.nan
    if root:
        # the float64 root of a float32, rounded to float32, is exact
        return math.nan if r < 0 else struct.unpack(
            "f", struct.pack("f", math.sqrt(r)))[0]
    return float(r)


def launch_ref(slots: dict, n_pairs: int = 0, lerp: bool = False,
               root: bool = False) -> torch.Tensor:
    """The plain version of one launch of :func:`_launch` (its slots and
    flags): what the kernel is held against."""
    if lerp:
        return lerp_ref(slots[0], slots[1], slots[2])
    pairs = [(slots[2 * k], slots[2 * k + 1]) for k in range(n_pairs)]
    return fma_chain_ref(pairs, slots.get(_C), slots.get(_D), root)


def prove_mismatches(out: torch.Tensor, ref: torch.Tensor, slots: dict,
                     n_pairs: int = 0, lerp: bool = False,
                     root: bool = False) -> int:
    """The number of elements where the kernel's ``out`` and the plain
    version's ``ref`` of one launch differ bit for bit (NaN where both are
    NaN counts as equal), once each of them is proven: the kernel's value
    equals :func:`exact_chain` on that element's operands, exactly. Raises
    AssertionError at the first element it cannot prove."""
    o, r = out.float(), ref.float().expand(out.shape)
    diff = (o.view(torch.int32) != r.view(torch.int32)) & ~(
        o.isnan() & r.isnan())
    where = diff.reshape(-1).nonzero().squeeze(1)
    if where.numel() == 0:
        return 0
    idx = torch.unravel_index(where, o.shape)
    vals = {s: (t.to(o.device) if t.dim() == 0 else t).float()
            .expand(o.shape)[idx].tolist() for s, t in slots.items()}
    got, plain = o[idx].tolist(), r[idx].tolist()
    for j, g in enumerate(got):
        v = {s: x[j] for s, x in vals.items()}
        e = exact_chain(v, n_pairs, lerp, root)
        if not g == e:          # NaN proves nothing
            raise AssertionError(
                f"fp: element {int(where[j])} of {tuple(o.shape)}: kernel "
                f"{g!r}, plain {plain[j]!r}, exact {e!r}, operands {v}")
    return len(got)

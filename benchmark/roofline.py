"""The kernel layer's arithmetic: the card's published peaks, a kernel's
least time, K3's work, and the ``__global__`` names of the hand-written
kernels.

``HBM_BYTES_PER_S``, ``F32_FLOPS``, ``bound`` (``_bound``) and ``GLOBALS``
are a frozen copy of ``chip_smoke.py`` at commit ea2b515. ``shade_work``
follows that file's ``shade_work`` but counts the bytes a frame's pixels
need, as ``csrc/shade.cu`` reads them: a background pixel reads its id and
the sky, a covered one its id, position, surface planes and gates; the
original counted every plane at every pixel, which a frame's K3 beats.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12     # H100 SXM, published
F32_FLOPS = 67e12

GLOBALS = {"K1": ("raster_kernel",), "K2": ("select_eval_kernel",),
           "K3": ("shade_kernel",),
           "K4": ("raster_stream_kernel", "stream_parts_kernel"),
           "K5": ("select_eval_stream_kernel",),
           "K6": ("raster_resolve_kernel",),
           "K7": ("windowed_blend_kernel", "windowed_blend_bytes_kernel"),
           "fp.fma": ("fp_fma_kernel",), "fp.lerp": ("fp_lerp_kernel",),
           "fp.plane": ("fp_plane_kernel",), "fp.sqrt": ("fp_sqrt_kernel",),
           "fp.fma_chain": ("fp_chain_kernel",)}


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """(least ms, what bounds it) for work that moves ``nbytes`` and does
    ``flops`` float32 operations."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def shade_work(pixels: int, covered: int, attr_planes: int, attr_bytes: int,
               material: bool, lights: int, sky: bool,
               ibl: bool) -> tuple[int, int]:
    """K3 over a padded frame of ``pixels``, ``covered`` of them by
    geometry: (bytes, operations). Every pixel reads its i32 id and writes
    3 f32; a background pixel reads the sky's 3 f32; a covered one its 3
    f32 position planes, ``attr_planes`` surface planes of ``attr_bytes``
    (8 on a flat-only frame: normal, albedo, roughness, metalness), the
    material's 9 f32 planes where there is one, and a f32 gate a light.
    The operations are an estimate, not a count of shade.cu: per pixel ~40
    of setup and sky, ~110 a light, ~100 for the SH-9 ambient; they stay
    below the bytes term."""
    background = pixels - covered
    nbytes = (pixels * 16 + background * (12 if sky else 0)
              + covered * (12 + attr_bytes * attr_planes
                           + (36 if material else 0) + 4 * lights))
    return nbytes, covered * (40 + 110 * lights + (100 if ibl else 0))


def is_program_kernel(name: str) -> bool:
    """Whether a device op's name is one of the hand-written kernels."""
    return any(g in name for names in GLOBALS.values() for g in names)

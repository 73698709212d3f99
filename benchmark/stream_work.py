"""The stream raster's work (K4, ``raster_stream_kernel``): the (tile,
triangle) pairs that the main view's stream binning made in a traced
stretch, and the bytes that K4 needs for them.

The pairs are the program's ``engine.stream_pairs`` marks (zero-length
spans named ``engine.stream_pairs:<pairs>:<tiles_y>:<tiles_x>:<tile_h>:
<tile_w>``, one a frame as the engine applies the frame's ``stream``
monitor, none where it reads 0), read from the trace of the stretch
itself, so that the pairs and K4's profiled time describe the same
frames.

``k4_bytes`` follows ``stream_work`` of ``chip_smoke.py`` at commit
c1de292, the bound of K4 in the port's table of kernels: the tile offsets
read, each walked row (16 float32) read once, a triangle id and a depth
written a pixel of the padded frame. Its rows are the pairs: a settled
frame's bins hold every tile's pairs, so each tile's walked window is its
whole segment.
"""

from __future__ import annotations

MARK = "engine.stream_pairs:"


def stream_pairs(window):
    """The mean pairs a frame over the ``engine.stream_pairs`` marks that
    start inside ``window`` (a ``trace.Window``) and the tile grid
    ``(tiles_y, tiles_x, tile_h, tile_w)`` of the last; None where the
    window holds no such mark with a pair, as where the program makes no
    marks or no frame took the stream path."""
    if window is None:
        return None
    marks = sorted(
        (float(e["ts"]), [int(v) for v in e["name"][len(MARK):].split(":")])
        for e in window.events
        if e.get("ph") == "X" and str(e.get("name", "")).startswith(MARK)
        and window.start <= float(e["ts"]) <= window.end)
    if not marks or not sum(m[0] for _, m in marks):
        return None
    return (sum(m[0] for _, m in marks) / len(marks), tuple(marks[-1][1][1:]))


def k4_bytes(pairs: float, tiles_y: int, tiles_x: int, tile_h: int,
             tile_w: int) -> float:
    """Bytes K4 moves for a frame of ``pairs`` pairs over a grid of
    ``tiles_y`` x ``tiles_x`` tiles of ``tile_h`` x ``tile_w``."""
    n_tiles = tiles_y * tiles_x
    return (n_tiles + 1) * 4 + pairs * 64 + n_tiles * tile_h * tile_w * 8

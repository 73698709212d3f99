"""K4 (``raster_stream_kernel``): its least time a frame, the bytes of the
profiled stretch's mean frame's pairs, their rows and the tile outputs
over the card's HBM rate (``stream_work.k4_bytes``, fed by the program's
``engine.stream_pairs`` marks in the same stretch), over its profiled
device time a launch, in percent. Nothing to read where K4 did not run or
the program makes no such marks."""

from ..roofline import bound
from ..stream_work import k4_bytes, stream_pairs


def read(data):
    w = data.window
    got = stream_pairs(w)
    if got is None:
        return None
    runs = [d for name, _, d in w.device if "raster_stream_kernel" in name]
    if not runs or sum(runs) <= 0:
        return None
    least_ms = bound(k4_bytes(got[0], *got[1]), 0.0)[0]
    return 100.0 * least_ms * len(runs) / (sum(runs) / 1e3)

"""Thousands of (tile, triangle) pairs that the main view's stream binning
made a frame, over the profiled stretch: the program's
``engine.stream_pairs`` marks in its trace (``stream_work.stream_pairs``).
Nothing to read where the program makes no such marks or no frame took
the stream path."""

from ..stream_work import stream_pairs


def read(data):
    got = stream_pairs(data.window)
    return got[0] / 1e3 if got is not None else None

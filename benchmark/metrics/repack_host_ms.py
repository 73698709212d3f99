"""Host ms of a repack (the program's ``engine.repack`` span: the walk
over the world's objects, the capacity-sized arrays, their upload), the
mean over the profiled stretch's repacks. Nothing to read where no frame
edits, or where the program records no span."""

from ..spans import mean_ms


def read(data):
    w = data.window
    return mean_ms(w, "engine.repack") if w is not None else None

"""Device ms of a shadow atlas: the kernels, copies and sets launched
inside the program's ``engine.atlas`` spans in the profiled stretch (by
their correlation ids), over the number of such spans. Nothing to read
where the atlas stays cached, or where the program records no span."""

from ..spans import device_ms


def read(data):
    w = data.window
    return device_ms(w, "engine.atlas") if w is not None else None

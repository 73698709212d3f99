"""Host ms of a repack's upload (the program's ``pack.upload`` span: the
scene's and the lights' arrays copied to the device), the mean over the
profiled stretch's repacks. Nothing to read where no frame edits, or where
the program records no span."""

from ..spans import mean_ms


def read(data):
    w = data.window
    return mean_ms(w, "pack.upload") if w is not None else None

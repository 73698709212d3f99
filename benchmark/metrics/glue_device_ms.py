"""Device ms a frame in the device ops (kernels, copies, sets) that are
not one of the hand-written kernels: PyTorch's own ops in the glue."""

from ..roofline import is_program_kernel


def read(data):
    w = data.window
    if w is None or not w.frames:
        return None
    us = sum(d for name, _, d in w.device if not is_program_kernel(name))
    return us / 1e3 / w.frames

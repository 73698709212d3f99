"""Device kernels, copies and sets in the profiled stretch, a frame."""


def read(data):
    w = data.window
    return len(w.device) / w.frames if w is not None and w.frames else None

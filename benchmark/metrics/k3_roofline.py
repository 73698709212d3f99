"""K3 (``shade_kernel``): its least time a frame (the bytes the frame's
covered and background pixels need over the card's HBM rate), times its
launches in the profiled stretch, over their summed device time, in
percent. Nothing to read where K3 did not run."""


def read(data):
    w = data.window
    if w is None or data.k3_bound_ms is None:
        return None
    runs = [d for name, _, d in w.device if "shade_kernel" in name]
    if not runs or sum(runs) <= 0:
        return None
    return 100.0 * data.k3_bound_ms * len(runs) / (sum(runs) / 1e3)

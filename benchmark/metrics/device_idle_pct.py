"""Share of the profiled stretch in which no kernel, copy or set ran on
the device, in percent."""


def read(data):
    w = data.window
    if w is None or w.length_us <= 0:
        return None
    return 100.0 * (1.0 - w.busy_us / w.length_us)

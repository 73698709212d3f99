"""Host ms a frame in the live shader-parameter call (the program's
``engine.set_param`` span), summed over the profiled stretch's calls and
divided by its frames. A frame's parameters are set before its call of
``Engine.run_frame``, so the calls made for the first profiled frame,
before the window opens, count, and those after the last frame's end do
not. Nothing to read where no parameter is set, or where the program
records no span."""

from ..spans import per_frame_ms


def read(data):
    w = data.window
    if w is None:
        return None
    return per_frame_ms(w, "engine.set_param", lead_in=True)

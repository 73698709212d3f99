"""Host ms of an ``Engine.run_frame`` call, the mean over the traced run's
frames outside the profiled stretch: the engine's update, its monitor
fetches (and waits), the replay's dispatch."""


def read(data):
    spans = data.host_ms
    return sum(spans) / len(spans) if spans else None

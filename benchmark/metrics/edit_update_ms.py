"""Host ms of ``Engine.update`` on the frames that carry an edit (the
repack runs there), the mean over the traced run's frames outside the
profiled stretch. Nothing to read where no frame edits."""


def read(data):
    spans = data.update_edit_ms
    return sum(spans) / len(spans) if spans else None

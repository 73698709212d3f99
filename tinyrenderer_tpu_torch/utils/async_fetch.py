"""Device->host fetches that never block the frame loop.

The engine reads its capacity monitors (a few int32 scalars a frame) on
the host, but a steady frame must not wait for them: a synchronous read
would make every frame wait for the device to finish. This is the
reference's ``map_async`` + poll (``src/pollable_gpu_buffer.rs:25-54``)
in PyTorch's idiom:

- :func:`submit_fetch` enqueues a copy of a CUDA tensor into pinned host
  memory (``non_blocking=True``, on the current stream) and records a
  ``torch.cuda.Event`` after it. The pinned memory comes from PyTorch's
  caching host allocator: a block is allocated once and handed out again
  only after the copies recorded on it have completed, so a frame
  allocates nothing and no value is read over.
- :meth:`Fetch.done` polls that event; :meth:`Fetch.result` waits on the
  event only, never on the whole device, and returns numpy.
- a CPU tensor's value is ready at once.
- :func:`drop_pending` keeps the fetches that are done and drops the rest.
  An enqueued copy cannot be taken back, so a dropped fetch is one whose
  value is never applied; a newer frame reports the same monitors.

:class:`Fetch` has the part of ``concurrent.futures.Future`` that the
engine uses: ``done``, ``result``, ``cancel`` and ``cancelled``.
"""

from __future__ import annotations

from concurrent.futures import CancelledError
from typing import Optional

import numpy as np
import torch


class Fetch:
    """One device->host copy: ready at once (a CPU tensor) or in flight
    into pinned memory until its event completes."""

    def __init__(self, value: Optional[np.ndarray] = None,
                 host: Optional[torch.Tensor] = None,
                 event: Optional[torch.cuda.Event] = None):
        self._value = value
        self._host = host
        self._event = event
        self._cancelled = False

    def done(self) -> bool:
        return (self._cancelled or self._value is not None
                or self._event.query())

    def result(self) -> np.ndarray:
        """The fetched values; waits for this copy's event if it has not
        completed. Raises ``CancelledError`` for a dropped fetch."""
        if self._cancelled:
            raise CancelledError()
        if self._value is None:
            if not self._event.query():
                self._event.synchronize()
            self._value = self._host.numpy().copy()
            self._host = self._event = None    # the pinned block goes back
        return self._value

    def cancel(self) -> bool:
        """Drop a fetch that is not done: its value is never applied.
        False (and nothing changes) when it is done."""
        if self.done():
            return self._cancelled
        self._cancelled = True
        self._host = self._event = None
        return True

    def cancelled(self) -> bool:
        return self._cancelled


def submit_fetch(t: torch.Tensor) -> Fetch:
    """Fetch ``t`` to the host without waiting: a CUDA tensor through
    pinned memory, a CPU tensor at once."""
    if t.device.type == "cpu":
        return Fetch(value=t.detach().numpy().copy())
    if t.device.type != "cuda":
        raise ValueError(f"no fetch from a {t.device} tensor")
    stream = torch.cuda.current_stream(t.device)
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    event = torch.cuda.Event()
    event.record(stream)
    return Fetch(host=host, event=event)


def drop_pending(fetches: list) -> list:
    """Drop the fetches that are not done; keep the rest (in order).
    Bounds the backlog when the device falls behind the frame loop."""
    return [f for f in fetches if f.done() or not f.cancel()]

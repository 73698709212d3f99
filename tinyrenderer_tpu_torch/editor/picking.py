"""Object-pick readback.

The reference renders an object-id texture, copies the whole map to the
host every frame and polls the copies: selection reads data a few frames
old. Its JAX port keeps that model with a background fetch thread.

Here the pick-id map is already an output of the frame (emitted by the
same raster pass as the GBuffer, so depth equality is exact), and a 1080p
int32 map is 8.3 MB, so nothing is copied per frame: the manager keeps the
newest frame's device ``pick_id`` tensor. ``get_object_id_at`` reads the
one element under the cursor (bounds checked on the host), and ``latest``
copies the whole map to the host lazily, at most once a frame.

Difference from the reference: selection reads the *newest* frame, where
the reference reads one a few frames old (its ``flush()`` makes it read the
newest too, which is how the parity tests line the two up). There is no
fetch queue, so ``update`` and ``flush`` have nothing to do.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


class PickReadbackManager:
    """The reference's ObjectPickManager, minus the extra GPU pass."""

    def __init__(self) -> None:
        self._pick: Optional[torch.Tensor] = None   # (H, W) int32, on device
        self._latest: Optional[np.ndarray] = None   # its host copy, lazily

    def on_end_frame(self, pick_id: torch.Tensor) -> None:
        """Keep this frame's device pick map."""
        self._pick = pick_id
        self._latest = None

    def update(self) -> None:
        """Nothing is in flight: the newest frame's map is always current."""

    def flush(self) -> None:
        """Nothing is in flight (kept for the reference's API)."""

    def get_object_id_at(self, x: float, y: float) -> int:
        """Object id under the cursor in the newest frame; 0 = no object,
        also outside the frame or before the first frame."""
        if self._pick is None:
            return 0
        h, w = self._pick.shape
        xi, yi = int(x), int(y)
        if 0 <= xi < w and 0 <= yi < h:
            if self._latest is not None:
                return int(self._latest[yi, xi])
            return int(self._pick[yi, xi])
        return 0

    @property
    def latest(self) -> Optional[np.ndarray]:
        """The newest frame's whole pick map on the host (copied once)."""
        if self._latest is None and self._pick is not None:
            self._latest = self._pick.cpu().numpy()
        return self._latest

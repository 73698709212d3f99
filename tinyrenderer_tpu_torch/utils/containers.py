"""Small host-side containers.

StableIndexMap mirrors the reference's SuperHashMap
(src/super_hash_map.rs — a stable-index slab with a free list; dead code in
the reference's module tree, but its unit tests define the intended
semantics, src/super_hash_map.rs:102-136). Useful for handle-keyed GPU
resource tables where indices must survive removals.
"""

from __future__ import annotations

from typing import Generic, Iterator, List, Optional, Tuple, TypeVar

T = TypeVar("T")


class StableIndexMap(Generic[T]):
    """Insert returns a stable integer handle; removal frees the slot for
    reuse without shifting other handles."""

    def __init__(self) -> None:
        self._slots: List[Optional[T]] = []
        self._free: List[int] = []
        self._len = 0

    def insert(self, value: T) -> int:
        self._len += 1
        if self._free:
            idx = self._free.pop()
            self._slots[idx] = value
            return idx
        self._slots.append(value)
        return len(self._slots) - 1

    def remove(self, idx: int) -> Optional[T]:
        if not (0 <= idx < len(self._slots)) or self._slots[idx] is None:
            return None
        value, self._slots[idx] = self._slots[idx], None
        self._free.append(idx)
        self._len -= 1
        return value

    def get(self, idx: int) -> Optional[T]:
        if 0 <= idx < len(self._slots):
            return self._slots[idx]
        return None

    def __len__(self) -> int:
        return self._len

    def __contains__(self, idx: int) -> bool:
        return self.get(idx) is not None

    def items(self) -> Iterator[Tuple[int, T]]:
        for i, v in enumerate(self._slots):
            if v is not None:
                yield i, v


class BasicTimer:
    """Per-frame delta clock (src/frame_timer.rs:14)."""

    def __init__(self) -> None:
        import time
        self._time = time
        self._last = time.monotonic()

    def get_delta_and_reset_timer(self) -> float:
        now = self._time.monotonic()
        delta, self._last = now - self._last, now
        return delta

"""Notification toasts (src/gui.rs:37-80,563-577): engine events surfaced
to whatever front-end is attached, with auto-expiry."""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List

DEFAULT_TTL_SECONDS = 5.0


@dataclass
class Notification:
    message: str
    level: str = "info"           # info | warning | error
    created: float = field(default_factory=time.monotonic)
    ttl: float = DEFAULT_TTL_SECONDS

    def expired(self, now: float) -> bool:
        return now - self.created > self.ttl


class Notifier:
    def __init__(self) -> None:
        self._items: List[Notification] = []

    def push(self, message: str, level: str = "info") -> None:
        self._items.append(Notification(message=message, level=level))

    def active(self) -> List[Notification]:
        """Drop expired toasts, return the live ones (src/gui.rs:587-599)."""
        now = time.monotonic()
        self._items = [n for n in self._items if not n.expired(now)]
        return list(self._items)

    def history(self) -> List[Notification]:
        """Every toast not yet pruned by active() — expiry-independent, so
        assertions about *what was pushed* don't race the 5 s TTL (a slow
        retrace between push and check expires the toast wall-clock)."""
        return list(self._items)

"""Input event model — the winit WindowEvent subset the editor consumes.

The reference routes winit events through App::handle_window_event
(src/app.rs:160-198) into the GUI, then the player controller
(src/player_controller.rs:95-167). A TPU host is headless, so events
arrive from whatever front-end streams the frames (web viewer, test
harness); this module is the neutral wire format between them.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum


class MouseButton(Enum):
    Left = "left"
    Right = "right"
    Middle = "middle"


@dataclass(frozen=True)
class CursorMoved:
    x: float
    y: float


@dataclass(frozen=True)
class MouseInput:
    button: MouseButton
    pressed: bool
    x: float
    y: float


@dataclass(frozen=True)
class MouseDelta:
    """Relative mouse motion (fly-mode look, src/camera.rs:159-167)."""

    dx: float
    dy: float


@dataclass(frozen=True)
class KeyInput:
    key: str            # "w", "a", "Delete", "Escape", "r", "f", "i", ...
    pressed: bool
    ctrl: bool = False


@dataclass(frozen=True)
class FileDropped:
    """Drag&drop a model file -> spawn world object
    (src/player_controller.rs:169-185)."""

    path: str
    x: float = 0.0
    y: float = 0.0


@dataclass(frozen=True)
class Resized:
    width: int
    height: int


Event = object  # union of the above; isinstance-dispatched

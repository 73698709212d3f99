"""EditorApp: the App-level glue for interactive editing.

Owns an Engine, the PlayerController (gizmo + camera input) and the pick
readback; sequences update -> render -> on_end_frame like the reference's
App::run_frame.
"""

from __future__ import annotations

import logging
from typing import Optional

from ..render.engine import Engine, RenderingAction
from ..render.global_params import GlobalParams
from . import events
from .controller import Action, PlayerController
from .params import ParamRegistry
from .picking import PickReadbackManager

log = logging.getLogger(__name__)


class EditorApp:
    def __init__(self, engine: Engine):
        self.engine = engine
        self.picker = PickReadbackManager()
        self.controller = PlayerController(
            engine.camera, engine.cfg.width, engine.cfg.height,
            self.picker.get_object_id_at)
        self.should_exit = False
        self.gui_visible = True
        # reflected runtime parameters: GlobalParams is always registered;
        # the selected object registers on selection (the reference's
        # GuiSettableValue RAII guard).
        self.registry = ParamRegistry()
        self.global_params = GlobalParams()
        self.registry.register("global_params", self.global_params)
        self.engine.params = self.global_params.to_device(self.engine.device)
        self._registered_object_id = None

    # -- events ---------------------------------------------------------------

    def handle_event(self, event) -> None:
        if isinstance(event, events.Resized):
            self.engine.resize(event.width, event.height)
        action = self.controller.handle_event(event, self.engine.world)
        if action is None:
            return
        if action is Action.RecompileShaders:
            self.engine.recompile_kernels()
        elif action is Action.Exit:
            self.should_exit = True
        elif action is Action.SaveIbl:
            self.engine.add_action(RenderingAction.SAVE_IRRADIANCE)
        elif action is Action.ToggleGui:
            self.gui_visible = not self.gui_visible

    # -- frame ----------------------------------------------------------------

    def _sync_registry(self) -> None:
        """Apply reflected-UI edits and keep the selected object
        registered."""
        for name in self.registry.drain_changes():
            if name == "global_params":
                self.global_params = self.registry.get(name)
                self.engine.params = self.global_params.to_device(
                    self.engine.device)
            elif name.startswith("object_"):
                oid = int(name.split("_", 1)[1])
                self.engine.world.mark_modified(oid)

        sel = self.selected_object_id
        if sel != self._registered_object_id:
            if self._registered_object_id is not None:
                self.registry.deregister(f"object_{self._registered_object_id}")
            if sel is not None:
                obj = self.engine.world.get_world_object(sel)
                if obj is not None:
                    self.registry.register(f"object_{sel}", obj)
            self._registered_object_id = sel

    def run_frame(self, delta_seconds: float = 0.016):
        # controller.camera is the same object as engine.camera unless the
        # engine reloaded a level — resync then.
        if self.controller.camera_input.camera is not self.engine.camera:
            self.controller.camera_input.camera = self.engine.camera
        self._sync_registry()
        self.controller.update(self.engine.world)
        out = self.engine.run_frame(delta_seconds)
        self.picker.on_end_frame(out.pick_id)
        self.picker.update()
        return out

    @property
    def selected_object_id(self) -> Optional[int]:
        return self.controller.selected_object_id

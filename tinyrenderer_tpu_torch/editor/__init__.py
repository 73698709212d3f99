"""Editor subsystem: reflection params, input events, picking, gizmo,
player controller, app session.

Exports resolve lazily (PEP 562): scene modules import
``tinyrenderer_tpu_torch.editor.params`` for ``ui_param`` field metadata,
and an eager import of the controller here would cycle back into the scene
package (controller -> scene.world -> scene.components -> editor.params).
"""

_EXPORTS = {
    "Action": ".controller",
    "CameraInputController": ".controller",
    "PlayerController": ".controller",
    "Gizmo": ".gizmo",
    "GizmoHandler": ".gizmo",
    "PickReadbackManager": ".picking",
    "EditorApp": ".session",
    "ParamRegistry": ".params",
    "ui_param": ".params",
    "describe": ".params",
    "set_by_path": ".params",
    "events": ".events",
}

__all__ = list(_EXPORTS)


def __getattr__(name: str):
    if name in _EXPORTS:
        import importlib
        mod = importlib.import_module(_EXPORTS[name], __name__)
        if name == "events":
            return mod
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

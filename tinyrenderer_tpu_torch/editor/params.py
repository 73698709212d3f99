"""Runtime parameter reflection.

The reference drives its editor GUI from proc-macro reflection: structs
derive ``UiDisplayable`` (describe yourself as a widget tree,
crates/ui_item/src/type_display.rs:128-235) and ``UiSettableNew`` (apply a
breadcrumb path of edits, crates/ui_item/src/type_setting.rs:31-205), with
per-field ``#[ui_param(min, max, skip, ...)]`` attributes
(crates/ui_item_derive/src/ui_display_derive.rs:6-21).

The Python-native equivalent: dataclass field ``metadata`` carries the same
attributes, :func:`describe` walks any dataclass into a JSON-able widget
tree, and :func:`set_by_path` applies ``(path..., value)`` edits back. Both
work on arbitrary nested dataclasses / enums / numpy vectors / lists, so any
engine object can be registered with a UI or CLI without bespoke glue.
"""

from __future__ import annotations

import dataclasses
from enum import Enum
from typing import Any, Sequence

import numpy as np

_UI_KEY = "ui_param"


def ui_param(*, min: float | None = None, max: float | None = None,
             skip: bool = False, kind: str | None = None,
             valid_file_extensions: Sequence[str] = (),
             file_description: str = "") -> dict:
    """Build dataclass-field metadata mirroring ``#[ui_param(...)]``."""
    return {_UI_KEY: {
        "min": min, "max": max, "skip": skip, "kind": kind,
        "valid_file_extensions": tuple(valid_file_extensions),
        "file_description": file_description,
    }}


def _meta(f: dataclasses.Field) -> dict:
    return f.metadata.get(_UI_KEY, {}) if f.metadata else {}


DEFAULT_MIN, DEFAULT_MAX = 0.0, 1.0


def describe(obj: Any, name: str = "") -> dict | None:
    """Describe ``obj`` as a widget-tree dict.

    Node kinds mirror UiDisplayDescription (type_display.rs:128-141):
    slider_float, slider_int, bool, vec3, rotation, path, enum, struct,
    vector.
    """
    return _describe(obj, name, {})


def _describe(obj: Any, name: str, meta: dict) -> dict | None:
    if meta.get("skip"):
        return None
    lo = meta.get("min") if meta.get("min") is not None else DEFAULT_MIN
    hi = meta.get("max") if meta.get("max") is not None else DEFAULT_MAX

    if isinstance(obj, bool):
        return {"kind": "bool", "name": name, "value": obj}
    if isinstance(obj, int) and not isinstance(obj, Enum):
        return {"kind": "slider_int", "name": name, "value": int(obj),
                "min": int(lo), "max": int(hi)}
    if isinstance(obj, float):
        return {"kind": "slider_float", "name": name, "value": float(obj),
                "min": float(lo), "max": float(hi)}
    if isinstance(obj, str) and meta.get("kind") == "path":
        return {"kind": "path", "name": name, "value": obj,
                "extensions": list(meta.get("valid_file_extensions", ())),
                "description": meta.get("file_description", "")}
    if isinstance(obj, Enum):
        variants = [v.name for v in type(obj)]
        return {"kind": "enum", "name": name, "value": obj.name,
                "variants": variants}
    if isinstance(obj, np.ndarray):
        if meta.get("kind") == "rotation" or obj.shape == (4,):
            return {"kind": "rotation", "name": name,
                    "value": [float(v) for v in obj]}
        if obj.shape == (3,):
            return {"kind": "vec3", "name": name,
                    "value": [float(v) for v in obj],
                    "min": float(lo), "max": float(hi)}
        return {"kind": "vector", "name": name,
                "items": [_describe(float(v), str(i), meta)
                          for i, v in enumerate(obj.ravel())]}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        fields = []
        for f in dataclasses.fields(obj):
            sub = _describe(getattr(obj, f.name), f.name, _meta(f))
            if sub is not None:
                fields.append(sub)
        return {"kind": "struct", "name": name, "fields": fields}
    if isinstance(obj, (list, tuple)):
        return {"kind": "vector", "name": name,
                "items": [_describe(v, str(i), {}) for i, v in enumerate(obj)]}
    if isinstance(obj, str):
        return {"kind": "path", "name": name, "value": obj,
                "extensions": [], "description": ""}
    return None


def set_by_path(obj: Any, path: Sequence[str | int], value: Any) -> Any:
    """Apply a breadcrumb edit; returns the (possibly replaced) object.

    Breadcrumbs are field names / indices from the describe() tree, e.g.
    ``set_by_path(world_obj, ("transform", "position", 1), 3.0)``. Enum
    fields accept the variant name. Mirrors SetPropertyFromUiDescription
    (type_setting.rs:31-43).
    """
    if not path:
        return _coerce_like(obj, value)
    head, rest = path[0], path[1:]
    if isinstance(obj, np.ndarray):
        idx = int(head)
        obj = obj.copy()
        obj[idx] = _coerce_like(obj[idx], set_by_path(obj[idx], rest, value))
        return obj
    if isinstance(obj, list):
        idx = int(head)
        obj[idx] = set_by_path(obj[idx], rest, value)
        return obj
    if isinstance(obj, tuple):
        idx = int(head)
        items = list(obj)
        items[idx] = set_by_path(items[idx], rest, value)
        return tuple(items)
    if dataclasses.is_dataclass(obj):
        cur = getattr(obj, str(head))
        new = set_by_path(cur, rest, value)
        try:
            setattr(obj, str(head), new)
            return obj
        except dataclasses.FrozenInstanceError:
            return dataclasses.replace(obj, **{str(head): new})
    raise KeyError(f"cannot descend into {type(obj)!r} with key {head!r}")


def _coerce_like(old: Any, value: Any) -> Any:
    if isinstance(old, Enum):
        return type(old)[value] if isinstance(value, str) else type(old)(value)
    if isinstance(old, bool):
        return bool(value)
    if isinstance(old, int):
        return int(value)
    if isinstance(old, float):
        return float(value)
    if isinstance(old, np.ndarray) and not isinstance(value, np.ndarray):
        return np.asarray(value, dtype=old.dtype).reshape(old.shape)
    if isinstance(old, np.floating):
        return type(old)(value)
    return value


class ParamRegistry:
    """Live registry of reflected items (the Gui register/deregister role,
    src/gui.rs:168-633 + src/gui_settable_value.rs).

    Items register under a name; the viewer/CLI lists descriptions and posts
    breadcrumb edits; ``drain_changes`` returns edits applied since the last
    call so owners can re-upload device state.
    """

    def __init__(self) -> None:
        self._items: dict[str, Any] = {}
        self._dirty: list[str] = []

    def register(self, name: str, obj: Any) -> None:
        self._items[name] = obj

    def deregister(self, name: str) -> None:
        self._items.pop(name, None)

    def names(self) -> list[str]:
        return sorted(self._items)

    def get(self, name: str) -> Any:
        return self._items[name]

    def describe(self, name: str) -> dict:
        return describe(self._items[name], name)

    def describe_all(self) -> dict:
        return {n: self.describe(n) for n in self.names()}

    def set(self, name: str, path: Sequence[str | int], value: Any) -> None:
        self._items[name] = set_by_path(self._items[name], list(path), value)
        self._dirty.append(name)

    def drain_changes(self) -> list[str]:
        out, self._dirty = self._dirty, []
        return out

"""Scene component model.

Mirrors the reference's component types (src/components.rs:209-241,
src/model.rs:97-227, src/material.rs:28-31, src/texture.rs:39-96) with
serde-compatible JSON encoding so `.lvl` files round-trip byte-for-byte
against levels written by the reference (src/world_loader.rs:16-77).

Rust serde conventions reproduced here:
- externally-tagged enums: ``{"VariantName": payload}``; unit variants are
  plain strings (``"DeferredMain"``).
- glam Vec3 -> 3-list, Quat -> 4-list (x, y, z, w).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from typing import List, Union

import numpy as np

from ..utils import math3d
from ..editor.params import ui_param

F32 = np.float32


def _v3(x) -> np.ndarray:
    return np.asarray(x, dtype=F32).reshape(3)


def _jlist(a: np.ndarray) -> list:
    return [float(v) for v in np.asarray(a, dtype=F32).ravel()]


# ---------------------------------------------------------------------------
# Transform
# ---------------------------------------------------------------------------

@dataclass
class TransformComponent:
    """Position/scale/rotation; serializes like src/components.rs:23."""

    position: np.ndarray = field(default_factory=lambda: np.zeros(3, F32),
                                 metadata=ui_param(min=-100.0, max=100.0))
    scale: np.ndarray = field(default_factory=lambda: np.ones(3, F32),
                              metadata=ui_param(min=0.001, max=100.0))
    rotation: np.ndarray = field(default_factory=math3d.quat_identity,
                                 metadata=ui_param(kind="rotation"))

    def model_matrix(self) -> np.ndarray:
        return math3d.compose_trs(self.position, self.rotation, self.scale)

    def normal_matrix(self) -> np.ndarray:
        return math3d.normal_matrix(self.model_matrix())

    def to_json(self) -> dict:
        return {
            "position": _jlist(self.position),
            "rotation": _jlist(self.rotation),
            "scale": _jlist(self.scale),
        }

    @classmethod
    def from_json(cls, d: dict) -> "TransformComponent":
        return cls(position=_v3(d["position"]), scale=_v3(d["scale"]),
                   rotation=np.asarray(d["rotation"], F32).reshape(4))


# ---------------------------------------------------------------------------
# Mesh / material descriptors
# ---------------------------------------------------------------------------

class PrimitiveShape(str, Enum):  # src/resource_loader.rs:41
    Cube = "Cube"
    Square = "Square"
    # Extension: the reference loads assets/models/arrow/arrow.obj for its
    # gizmo (src/gizmo.rs:266-276); we generate the arrow procedurally so
    # the gizmo works without shipping binary assets.
    Arrow = "Arrow"
    # Extension: high-poly primitive for stress/bench scenes.
    Sphere = "Sphere"


@dataclass(frozen=True)
class MeshDescriptor:
    """``PrimitiveInCode(shape)`` or ``FromFile(path)`` (src/model.rs:220)."""

    kind: str  # "PrimitiveInCode" | "FromFile"
    value: str

    @classmethod
    def primitive(cls, shape: PrimitiveShape) -> "MeshDescriptor":
        return cls("PrimitiveInCode", shape.value)

    @classmethod
    def from_file(cls, path: str) -> "MeshDescriptor":
        return cls("FromFile", str(path))

    def to_json(self) -> dict:
        return {self.kind: self.value}

    @classmethod
    def from_json(cls, d: dict) -> "MeshDescriptor":
        (k, v), = d.items()
        return cls(k, v)


class TextureUsage(str, Enum):  # src/texture.rs:89
    Albedo = "Albedo"
    Normal = "Normal"
    Metalness = "Metalness"
    Roughness = "Roughness"
    HdrAlbedo = "HdrAlbedo"


@dataclass(frozen=True)
class TextureSourceDescriptor:
    """src/texture.rs:59-66: {source: FromFile(path)|Default, usage}."""

    usage: TextureUsage
    path: str | None = None  # None == Default

    def to_json(self) -> dict:
        source = {"FromFile": self.path} if self.path is not None else "Default"
        return {"source": source, "usage": self.usage.value}

    @classmethod
    def from_json(cls, d: dict) -> "TextureSourceDescriptor":
        src = d["source"]
        path = None if src == "Default" else src["FromFile"]
        return cls(usage=TextureUsage(d["usage"]), path=path)


@dataclass
class PbrParameters:
    """Flat material parameters (src/model.rs:36-60)."""

    albedo: np.ndarray = field(default_factory=lambda: np.array([1.0, 0.0, 0.0], F32),
                               metadata=ui_param(min=0.0, max=1.0))
    roughness: float = field(default=1.0, metadata=ui_param(min=0.0, max=1.0))
    metalness: float = field(default=0.0, metadata=ui_param(min=0.0, max=1.0))

    def to_json(self) -> dict:
        return {
            "albedo": _jlist(self.albedo),
            "metalness": float(self.metalness),
            "roughness": float(self.roughness),
        }

    @classmethod
    def from_json(cls, d: dict) -> "PbrParameters":
        return cls(albedo=_v3(d["albedo"]), roughness=float(d["roughness"]),
                   metalness=float(d["metalness"]))


@dataclass(frozen=True)
class PbrMaterialDescriptor:
    """``Texture([...])`` or ``Flat(params)`` (src/material.rs:28-31)."""

    flat: PbrParameters | None = None
    textures: tuple = ()

    @property
    def is_flat(self) -> bool:
        return self.flat is not None

    @classmethod
    def from_color(cls, color) -> "PbrMaterialDescriptor":
        return cls(flat=PbrParameters(albedo=_v3(color)))

    def to_json(self) -> dict:
        if self.is_flat:
            return {"Flat": self.flat.to_json()}
        return {"Texture": [t.to_json() for t in self.textures]}

    @classmethod
    def from_json(cls, d: dict) -> "PbrMaterialDescriptor":
        if "Flat" in d:
            return cls(flat=PbrParameters.from_json(d["Flat"]))
        return cls(textures=tuple(TextureSourceDescriptor.from_json(t)
                                  for t in d["Texture"]))


class RenderingPass(str, Enum):  # src/model.rs:97
    DeferredMain = "DeferredMain"
    ForceForwardAfterDeferred = "ForceForwardAfterDeferred"


class PbrRenderingType(str, Enum):  # src/model.rs:121
    Textures = "Textures"
    FlatParameters = "FlatParameters"


@dataclass
class ModelRenderingOptions:
    """src/model.rs:138-149."""

    pass_: RenderingPass = RenderingPass.DeferredMain
    use_depth_test: bool = True
    cast_shadows: bool = True
    pbr_resource_type: PbrRenderingType = PbrRenderingType.Textures

    def to_json(self) -> dict:
        return {
            "cast_shadows": bool(self.cast_shadows),
            "pass": self.pass_.value,
            "pbr_resource_type": self.pbr_resource_type.value,
            "use_depth_test": bool(self.use_depth_test),
        }

    @classmethod
    def from_json(cls, d: dict) -> "ModelRenderingOptions":
        return cls(
            pass_=RenderingPass(d["pass"]),
            use_depth_test=bool(d.get("use_depth_test", True)),
            cast_shadows=bool(d.get("cast_shadows", True)),
            pbr_resource_type=PbrRenderingType(d["pbr_resource_type"]),
        )


@dataclass
class ModelDescriptor:
    """src/model.rs:173."""

    mesh_descriptor: MeshDescriptor = field(
        default_factory=lambda: MeshDescriptor.primitive(PrimitiveShape.Cube))
    material_descriptor: PbrMaterialDescriptor = field(
        default_factory=lambda: PbrMaterialDescriptor(flat=PbrParameters()))

    def to_json(self) -> dict:
        return {
            "material_descriptor": self.material_descriptor.to_json(),
            "mesh_descriptor": self.mesh_descriptor.to_json(),
        }

    @classmethod
    def from_json(cls, d: dict) -> "ModelDescriptor":
        return cls(
            mesh_descriptor=MeshDescriptor.from_json(d["mesh_descriptor"]),
            material_descriptor=PbrMaterialDescriptor.from_json(d["material_descriptor"]),
        )


# ---------------------------------------------------------------------------
# Components
# ---------------------------------------------------------------------------

@dataclass
class RenderableComponent:
    """src/components.rs:156-163. ``is_transient`` is runtime-only."""

    model_descriptor: ModelDescriptor = field(default_factory=ModelDescriptor)
    rendering_options: ModelRenderingOptions = field(default_factory=ModelRenderingOptions)
    is_transient: bool = field(default=False, metadata=ui_param(skip=True))

    def to_json(self) -> dict:
        return {
            "model_descriptor": self.model_descriptor.to_json(),
            "rendering_options": self.rendering_options.to_json(),
        }

    @classmethod
    def from_json(cls, d: dict) -> "RenderableComponent":
        return cls(
            model_descriptor=ModelDescriptor.from_json(d["model_descriptor"]),
            rendering_options=ModelRenderingOptions.from_json(d["rendering_options"]),
        )


@dataclass
class PointLight:
    """src/lights.rs PointLight — color only; position from the transform."""

    color: np.ndarray = field(default_factory=lambda: np.ones(3, F32),
                              metadata=ui_param(min=0.0, max=100.0))

    def to_json(self) -> dict:
        return {"color": _jlist(self.color)}

    @classmethod
    def from_json(cls, d: dict) -> "PointLight":
        return cls(color=_v3(d["color"]))


@dataclass
class LightObjectComponent:
    """src/components.rs:197."""

    light: PointLight = field(default_factory=PointLight)

    def to_json(self) -> dict:
        return {"light": self.light.to_json()}

    @classmethod
    def from_json(cls, d: dict) -> "LightObjectComponent":
        return cls(light=PointLight.from_json(d["light"]))


@dataclass
class DirectionalLight:
    """src/lights.rs DirectionalLight."""

    direction: np.ndarray = field(default_factory=lambda: np.array([0.0, -1.0, 0.0], F32),
                                  metadata=ui_param(min=-1.0, max=1.0))
    color: np.ndarray = field(default_factory=lambda: np.ones(3, F32),
                              metadata=ui_param(min=0.0, max=100.0))

    def to_json(self) -> dict:
        return {"color": _jlist(self.color), "direction": _jlist(self.direction)}

    @classmethod
    def from_json(cls, d: dict) -> "DirectionalLight":
        return cls(direction=_v3(d["direction"]), color=_v3(d["color"]))


SceneComponentType = Union[LightObjectComponent, RenderableComponent]


def scene_component_to_json(c: SceneComponentType) -> dict:
    if isinstance(c, LightObjectComponent):
        return {"LightObject": c.to_json()}
    if isinstance(c, RenderableComponent):
        return {"Renderable": c.to_json()}
    raise TypeError(f"not a scene component: {type(c)}")


def scene_component_from_json(d: dict) -> SceneComponentType:
    (k, v), = d.items()
    if k == "LightObject":
        return LightObjectComponent.from_json(v)
    if k == "Renderable":
        return RenderableComponent.from_json(v)
    raise ValueError(f"unknown scene component variant: {k}")


def omnipresent_component_to_json(c) -> dict:
    if isinstance(c, DirectionalLight):
        return {"DirectionalLight": c.to_json()}
    raise TypeError(f"not an omnipresent component: {type(c)}")


def omnipresent_component_from_json(d: dict):
    (k, v), = d.items()
    if k == "DirectionalLight":
        return DirectionalLight.from_json(v)
    raise ValueError(f"unknown omnipresent component variant: {k}")


def is_transient(c: SceneComponentType) -> bool:
    """src/components.rs:214-224."""
    return isinstance(c, RenderableComponent) and c.is_transient


__all__ = [name for name in dir() if not name.startswith("_")]

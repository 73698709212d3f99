"""The one traffic generator: a mix file (``traffic/<mix>.json``) sets its
parameters, the seed the choices, and each frame's inputs follow the frame
index alone, so every frame's work is the same on both sides of a
comparison.

A mix's keys:

- ``camera``: ``{"mode": "orbit", "frames_per_turn": n, "center": [x, y,
  z], "radius_of_bound": a, "elevation_of_bound": b}`` circles ``center``
  at ``a`` times the scene's horizontal bound, ``b`` times it up, from a
  start angle and in a direction drawn from the seed (the warm-up's
  frames turn from angle 0 the same way whatever the seed, so that set-up
  meets the poses in one order); ``{"mode": "fixed"}`` keeps the scene's
  own camera;
- ``drag`` (optional): ``{"amplitude": A, "step": s, "axes": [...]}``
  moves one object every frame along an axis drawn from ``axes`` (an
  object drawn from the deferred ones, never the largest, the ground) on
  a triangle wave of +-A at s a frame, through the world call that marks
  it modified;
- ``warmup_frames``: frames run before the window at least;
- ``delta_seconds``: the time step handed to each frame.

A configuration's ``live_params`` (``{"exposure": [lo, hi]}``) are set
every frame to a value drawn from the seed in [lo, hi).

The orbit's pose (a radius, a height, an angle a frame, the camera looking
at the centre) is that of ``tinyrenderer_tpu_torch/tools/orbit.py`` at
commit ea2b515.
"""

from __future__ import annotations

import copy
import math
from dataclasses import dataclass, field

import numpy as np

from .reference import scene as refscene

F32 = np.float32
_BLOCK = 4096
_AXES = {"x": 0, "y": 1, "z": 2}


@dataclass
class FrameInput:
    index: int
    camera: tuple | None = None        # (eye, forward) or None: unchanged
    moves: dict = field(default_factory=dict)    # oid -> position
    params: dict = field(default_factory=dict)   # name -> value

    @property
    def edits(self) -> bool:
        return bool(self.moves)


def _seed(seed: int) -> int:
    return int(seed) & ((1 << 64) - 1)


def triangle_wave(t: float, amplitude: float) -> float:
    """0 at t = 0, rising at slope 1 to +amplitude, down to -amplitude, back."""
    p = t % (4.0 * amplitude)
    if p <= amplitude:
        return p
    if p <= 3.0 * amplitude:
        return 2.0 * amplitude - p
    return p - 4.0 * amplitude


class Traffic:
    def __init__(self, mix: dict, config: dict, scene: dict, seed: int):
        self.mix = mix
        self.seed = _seed(seed)
        self.scene = scene
        self.delta_seconds = float(mix.get("delta_seconds", 1.0 / 60.0))
        self.warmup_frames = int(mix.get("warmup_frames", 0))
        rng = np.random.default_rng(self.seed)
        cam = mix["camera"]
        self.orbit = None
        if cam["mode"] == "orbit":
            bound = refscene.horizontal_bound(scene)
            self.orbit = dict(
                center=np.asarray(cam.get("center", [0.0, 0.0, 0.0]), np.float64),
                radius=cam["radius_of_bound"] * bound,
                elevation=cam["elevation_of_bound"] * bound,
                start=float(rng.uniform(0.0, 2.0 * math.pi)),
                turn=float(rng.choice([-1.0, 1.0])) * 2.0 * math.pi
                / cam["frames_per_turn"])
        elif cam["mode"] != "fixed":
            raise ValueError(f"unknown camera mode {cam['mode']!r}")
        self.drag = None
        if mix.get("drag"):
            d = mix["drag"]
            movable = [o for o in scene["objects"] if not o["forward"]]
            ground = max(movable, key=lambda o: o["scale"][0] * o["scale"][2])
            movable = [o for o in movable if o is not ground]
            obj = movable[int(rng.integers(len(movable)))]
            self.drag = dict(oid=obj["oid"],
                             origin=np.asarray(obj["position"], np.float64),
                             axis=_AXES[d["axes"][int(rng.integers(len(d["axes"])))]],
                             amplitude=float(d["amplitude"]),
                             step=float(d["step"]))
        self.live = dict(config.get("live_params", {}))
        self._blocks: dict = {}

    def _uniform(self, k: int, i: int) -> float:
        """The i-th draw of the k-th live parameter, in [0, 1)."""
        key = (k, i // _BLOCK)
        if key not in self._blocks:
            self._blocks[key] = np.random.default_rng(
                (self.seed, k + 1, i // _BLOCK)).random(_BLOCK)
        return float(self._blocks[key][i % _BLOCK])

    def warmup_frame(self, i: int) -> FrameInput:
        """Frame ``i`` of set-up: :meth:`frame`, the orbit from angle 0."""
        return self.frame(i, warmup=True)

    def frame(self, i: int, warmup: bool = False) -> FrameInput:
        inp = FrameInput(index=i)
        if self.orbit is not None:
            o = self.orbit
            a = (2.0 * math.pi * i / self.mix["camera"]["frames_per_turn"]
                 if warmup else o["start"] + o["turn"] * i)
            eye = o["center"] + np.array([o["radius"] * math.cos(a),
                                          o["elevation"],
                                          o["radius"] * math.sin(a)])
            fwd = o["center"] - eye
            inp.camera = (eye.astype(F32), (fwd / np.linalg.norm(fwd)).astype(F32))
        if self.drag is not None:
            d = self.drag
            p = d["origin"].copy()
            p[d["axis"]] += triangle_wave(d["step"] * i, d["amplitude"])
            inp.moves[d["oid"]] = p.astype(F32)
        for k, (name, (lo, hi)) in enumerate(sorted(self.live.items())):
            inp.params[name] = float(F32(lo + (hi - lo) * self._uniform(k, i)))
        return inp

    def scene_at(self, inp: FrameInput) -> dict:
        """The plain scene as frame ``inp`` renders it."""
        s = copy.deepcopy(self.scene)
        if inp.camera is not None:
            s["camera"]["position"] = [float(v) for v in inp.camera[0]]
            s["camera"]["forward"] = [float(v) for v in inp.camera[1]]
        for o in s["objects"]:
            if o["oid"] in inp.moves:
                o["position"] = [float(v) for v in inp.moves[o["oid"]]]
        return s


def apply(eng, inp: FrameInput) -> None:
    """Hand frame ``inp``'s inputs to the engine through its public calls:
    the camera's position and look-at, the world's mutable object (which
    marks it modified), the parameter vector."""
    from tinyrenderer_tpu_torch.render import frame as framelib

    if inp.camera is not None:
        eye, fwd = inp.camera
        eng.camera.position = eye.copy()
        eng.camera.look_at(eye + fwd)
    for oid, pos in inp.moves.items():
        eng.world.get_world_object_mut(oid).transform.position = pos.copy()
    for name, value in inp.params.items():
        eng.set_param(getattr(framelib, "PARAM_" + name.upper()), value)

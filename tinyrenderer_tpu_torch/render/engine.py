"""Engine (port of render/engine.py): world + camera + packed scene +
environment around :func:`frame.render_frame`.

``run_frame`` = ``update`` (repack when the world changed) -> ``render``
(the queued rendering actions, the environment, one frame; the shadow
atlas is cached until the next repack) -> ``on_end_frame``.

Capacity monitors. ``RenderConfig`` is a static envelope: a raster bin, a
stream or a compacted block list that wants more than its capacity drops
work (unshaded blocks, missing triangles). Every frame reports what each
wanted, as one small int32 stack a group, and the engine grows an
overflowed capacity to the next bucket (a long run under 40% occupancy
shrinks it again). The protocol is the reference's:

- ``render()`` is correct by construction. A frame under a config that has
  not been verified (a fresh engine, or any change of ``cfg``: resolution,
  preset, light counts, a capacity) reads its monitors synchronously and
  is rendered again, up to four times, while a capacity grew. The frame
  handed out is the settled one: the headless CLI, a screenshot and the
  viewer's first frame after a preset never ship dropped blocks.
- a settled frame never waits for its monitors: they are copied to the
  host without blocking (``utils/async_fetch``) and the oldest fetch that
  is done is applied by the next frames; at most four are in flight and
  the rest are dropped. ``drain_monitors()`` is the blocking form.

The environment is the procedural sky or an HDR skybox file
(``skybox_path``) baked to a cube, and its diffuse irradiance map: a raw
float16 cache file (``ibl_cache_path``) when one of the right size exists,
else the embedded map for the procedural sky, else the bake (written to
the cache path when one is given).

Host surfaces: ``notifier`` carries toasts (a capacity grown, a kernel
reload) to whatever front end is attached, and ``recompile_kernels``
reloads changed ``ops`` modules and, on the card, rebuilds the CUDA
library after an edit of ``csrc/`` (``render/reload.py``). The XLA compile
cache of the reference has no counterpart: nothing here is compiled per
config.
"""

from __future__ import annotations

import logging
import os
import time
from dataclasses import replace
from typing import Optional

import numpy as np
import torch

from .. import config
from ..assets import hdr as hdrlib
from ..ops import compact, post, sampling
from ..scene import level_io
from ..scene.camera import Camera
from ..scene.world import World
from ..utils import async_fetch
from ..utils.notify import Notifier
from . import frame as framelib
from . import reload as reloadlib
from .scene_gpu import CapacityError, PackResult, ScenePacker

log = logging.getLogger(__name__)

# the embedded irradiance map baked from the default procedural sky
DEFAULT_IBL = os.path.join(os.path.dirname(hdrlib.__file__),
                           "default_ibl.npz")


class RenderingAction:
    """The deferred environment actions an engine drains before a frame."""

    GENERATE_CUBEMAP = "GenerateCubeMapFromEquirectangular"
    BAKE_IRRADIANCE = "BakeDiffuseIrradianceMap"
    SAVE_IRRADIANCE = "SaveDiffuseIrradianceMapToFile"


class Engine:
    # consecutive under-occupancy frames before a capacity shrinks
    SHRINK_AFTER = 120
    # capacity monitors: kind -> (config field, log label)
    _MONITORS = {
        "bins": ("bin_capacity", "Raster bin overflow"),
        "binsbig": ("bin_big_capacity", "Big-triangle list overflow"),
        "shadow": ("shadow_bin_capacity", "Shadow bin overflow"),
        "tex": ("tex_block_capacity", "Textured-block overflow"),
        "fwdtex": ("fwd_tile_capacity", "Forward overlay tile overflow"),
        "shadowblk": ("shadow_block_capacity",
                      "Shadow boundary-block overflow"),
        "skyblk": ("sky_block_capacity", "Sky background-block overflow"),
        "stream": ("stream_capacity", "Raster stream overflow"),
    }
    # block-compaction work lists: grown and shrunk in 256-block steps
    _BLOCK_KINDS = ("tex", "fwdtex", "shadowblk", "skyblk")

    def __init__(self, cfg: Optional[config.RenderConfig] = None, *,
                 device, level_path: Optional[str] = None,
                 asset_search_paths: tuple[str, ...] = (".",),
                 skybox_path: Optional[str] = None,
                 ibl_cache_path: Optional[str] = None):
        self.device = torch.device(device)
        self._settled = False     # capacities verified under this cfg
        self.cfg = cfg or config.RenderConfig()
        self.asset_search_paths = asset_search_paths
        self.world = World()
        self.camera = Camera.new_default(self.cfg.width, self.cfg.height)
        self.params = framelib.default_params(self.device)
        self._packer = ScenePacker(self.cfg, asset_search_paths)
        self._pack: Optional[PackResult] = None
        self._needs_pack = True
        self._actions: list[str] = []
        self._env: Optional[framelib.EnvGPU] = None
        self._equirect: Optional[torch.Tensor] = None
        self._equirect_is_file = False
        self._skybox_path = skybox_path
        self._ibl_cache_path = ibl_cache_path
        self._atlas: Optional[torch.Tensor] = None
        self._shadow_big_need = 0
        self._under_count: dict = {}
        self._overflow_inflight: list = []   # (kinds, Fetch), oldest first
        self.frame_index = 0
        self.last_output: Optional[framelib.FrameOutput] = None
        self.last_frame_ms = 0.0
        self.notifier = Notifier()
        self._reloader = reloadlib.KernelReloader()
        if level_path is not None:
            self.load_level(level_path)
        self.add_action(RenderingAction.GENERATE_CUBEMAP)

    @property
    def cfg(self) -> config.RenderConfig:
        return self._cfg

    @cfg.setter
    def cfg(self, value: config.RenderConfig) -> None:
        # any envelope change (resolution, preset, light counts, a capacity)
        # re-arms the synchronous settle of render(): a frame under the new
        # config is handed out only once its capacities held
        if getattr(self, "_cfg", None) != value:
            self._settled = False
        self._cfg = value

    @classmethod
    def from_world(cls, world: World, camera: Optional[Camera] = None,
                   cfg: Optional[config.RenderConfig] = None,
                   **kwargs) -> "Engine":
        eng = cls(cfg=cfg, **kwargs)
        eng.world = world
        if camera is not None:
            eng.camera = camera
            eng.camera.resize(eng.cfg.width, eng.cfg.height)
        eng._needs_pack = True
        return eng

    def load_level(self, path: str) -> None:
        level = level_io.load_level(path)
        self.world = level.world
        self.camera = level.camera
        self.camera.resize(self.cfg.width, self.cfg.height)
        self._needs_pack = True

    def save_level(self, path: str) -> None:
        level_io.save_level(path, self.world, self.camera)

    # -- environment --------------------------------------------------------

    def _get_equirect(self) -> torch.Tensor:
        """The skybox HDR file when ``skybox_path`` names one, else the
        procedural sky, on the engine's device."""
        if self._equirect is None:
            p = self._skybox_path
            self._equirect_is_file = bool(p) and os.path.exists(p)
            eq = (hdrlib.load_hdr(p) if self._equirect_is_file
                  else hdrlib.procedural_sky())
            self._equirect = torch.as_tensor(eq, device=self.device)
        return self._equirect

    def _ensure_env(self) -> framelib.EnvGPU:
        """The env cube (a file is gamma-decoded, the procedural sky is
        linear), its irradiance map and SH-9 projection, and the
        windowed-RGBE display cube."""
        if self._env is None:
            eq = self._get_equirect()
            cube = framelib.bake_env_cubemap(
                eq, self.cfg.env_size, gamma_decode=self._equirect_is_file)
            irr = self._load_or_bake_irradiance(cube)
            self._env = framelib.EnvGPU(
                env_cube=cube, irradiance=irr,
                irradiance_sh=framelib.project_irradiance_sh(irr),
                sky_rgbe=sampling.encode_rgbe_windowed(cube))
        return self._env

    def _load_or_bake_irradiance(self, cube: torch.Tensor) -> torch.Tensor:
        """(6, s, s, 3) irradiance: the raw float16 RGBA cache of 6 s s 4
        values, else (no skybox) the embedded map, resized as the
        reference resizes it (the map is smooth), else the bake of
        ``cube``, then written to the cache path when one is given."""
        s = self.cfg.irradiance_size
        p = self._ibl_cache_path
        if p and os.path.exists(p):
            raw = np.fromfile(p, np.float16)
            if raw.size == 6 * s * s * 4:
                irr = raw.reshape(6, s, s, 4)[..., :3].astype(np.float32)
                return torch.as_tensor(irr, device=self.device)
            log.warning("IBL cache %s has the wrong size; rebaking", p)
        if self._skybox_path is None:
            irr = torch.as_tensor(
                np.load(DEFAULT_IBL)["irradiance"].astype(np.float32),
                device=self.device)
            if irr.shape[1] != s:
                irr = post.resize_linear(irr, (6, s, s, 3))
            return irr
        t0 = time.perf_counter()
        irr = framelib.bake_irradiance(cube, s)
        log.info("irradiance bake: %.3f s", time.perf_counter() - t0)
        if p:
            self.write_ibl_to_file(p, irr)
        return irr

    def write_ibl_to_file(self, path: str,
                          irr: Optional[torch.Tensor] = None) -> None:
        """The irradiance map (the current one by default) as raw float16
        RGBA, face-major, alpha 1."""
        if irr is None:
            if self._env is None:
                return
            irr = self._env.irradiance
        a = irr.cpu().numpy()
        rgba = np.concatenate([a, np.ones((*a.shape[:-1], 1), np.float32)],
                              axis=-1)
        rgba.astype(np.float16).tofile(path)

    def set_skybox(self, path: Optional[str]) -> None:
        """Swap the environment HDR; the environment is baked again."""
        self._skybox_path = path
        self._equirect = None
        self._env = None

    # -- actions ------------------------------------------------------------

    def add_action(self, action: str) -> None:
        self._actions.append(action)

    def _drain_actions(self) -> None:
        for action in self._actions:
            if action == RenderingAction.GENERATE_CUBEMAP:
                self._env = None          # baked again on use
            elif action == RenderingAction.BAKE_IRRADIANCE:
                if self._env is not None:
                    irr = framelib.bake_irradiance(self._env.env_cube,
                                                   self.cfg.irradiance_size)
                    self._env = replace(
                        self._env, irradiance=irr,
                        irradiance_sh=framelib.project_irradiance_sh(irr))
            elif action == RenderingAction.SAVE_IRRADIANCE:
                self.write_ibl_to_file(self._ibl_cache_path
                                       or "output_ibl.data")
        self._actions.clear()

    # -- live kernel reload (the shader hot-recompile analog) ---------------

    def recompile_kernels(self) -> reloadlib.ReloadResult:
        """Ctrl+R / the GUI's "Recompile shaders": reload the changed
        ``ops`` modules and, on the card, rebuild the CUDA library if
        ``csrc/`` changed (an engine on the CPU never runs ``nvcc``);
        re-enqueue the environment bakes if ``ops.env`` changed."""
        result = self._reloader.reload_if_changed(
            library=self.device.type == "cuda")
        if any(m != reloadlib.LIBRARY for m in result.reloaded):
            # importlib.reload replaced the modules' classes: the packer's
            # pool and the last pack are instances of the old ones
            self._packer = ScenePacker(self.cfg, self.asset_search_paths)
            self._needs_pack = True
        if not result.ok:
            self.notifier.push(f"Kernel reload failed: {result.error}", "error")
            return result
        if result.changed:
            if any(m.endswith(".env") for m in result.reloaded):
                self.add_action(RenderingAction.GENERATE_CUBEMAP)
                self.add_action(RenderingAction.BAKE_IRRADIANCE)
            self.notifier.push(
                "Reloaded kernels: "
                + ", ".join(m.rsplit(".", 1)[-1] for m in result.reloaded))
        else:
            self.notifier.push("Kernels up to date")
        return result

    # -- params and frame lifecycle -----------------------------------------

    def set_param(self, index: int, value: float) -> None:
        self.params[index] = value

    def update(self, delta_seconds: float = 0.0) -> None:
        self.camera.update(delta_seconds)
        if self.world.dirty_objects:
            self._needs_pack = True
        if self._needs_pack:
            self._repack()

    def _repack(self) -> None:
        self._atlas = None   # scene or lights changed: shadow maps are stale
        # the packer's texture pool is sized when it is built: a config
        # whose pool envelope changed at run time (a preset with another
        # texture_size or mip_levels) needs a new packer, or the frame goes
        # on sampling the old pyramid
        p = self._packer.pool
        if (p.size != self.cfg.texture_size or p.levels != self.cfg.mip_levels
                or p.capacity != self.cfg.max_textures):
            self._packer = ScenePacker(self.cfg, self.asset_search_paths)
        try:
            self._pack = self._packer.pack(self.world, self.device)
        except CapacityError as e:
            c = e.counts
            log.info("growing capacities for %s", c)
            self.cfg = self.cfg.grown_for(
                c["instances"], c["vertices"], c["triangles"], c["materials"],
                c["point_lights"], c["directional_lights"], c["textures"],
                c["forward_triangles"], c["unique_vertices"])
            self._packer = ScenePacker(self.cfg, self.asset_search_paths)
            self._pack = self._packer.pack(self.world, self.device)
        # light counts set the shadow-view count; forward triangles and
        # textured materials select frame paths. The pack itself reads none
        # of the four fields (only the max_* capacities and the pool), so
        # it is not packed again under the new config
        c = self._pack.counts
        has_fwd = c["forward_triangles"] > 0
        any_tex = c["textured_materials"] > 0
        if (c["point_lights"] != self.cfg.num_point_lights
                or c["directional_lights"] != self.cfg.num_directional_lights
                or has_fwd != self.cfg.has_forward
                or any_tex != self.cfg.any_textured):
            self.cfg = replace(self.cfg,
                               num_point_lights=c["point_lights"],
                               num_directional_lights=c["directional_lights"],
                               has_forward=has_fwd, any_textured=any_tex)
        self._needs_pack = False

    def render(self) -> framelib.FrameOutput:
        """One frame, correct by construction: an unsettled frame reads its
        monitors synchronously and is rendered again (at most four times)
        while a capacity grew; a settled frame only applies fetches that
        are done."""
        out = self._render_once()
        for _ in range(4):       # growth converges: capacity >= what was wanted
            if self._settled or not self._settle_sync():
                self._settled = True
                break
            out = self._render_once()
        return out

    def _render_once(self) -> framelib.FrameOutput:
        if self._pack is None or self._needs_pack:
            self._repack()
        self._drain_actions()
        env = self._ensure_env()
        cam_raw = torch.from_numpy(self.camera.to_raw())
        if self.device.type == "cuda":   # an upload that does not synchronize
            cam_raw = cam_raw.pin_memory()
        cam_raw = cam_raw.to(self.device, non_blocking=True)
        t0 = time.perf_counter()
        if (self._atlas is None and self.cfg.enable_shadows
                and self.cfg.num_shadow_views > 0):
            # camera-independent: rendered once per scene edit
            self._atlas, s_ovf, s_big = framelib.render_shadow_atlas(
                self._pack.scene, self._pack.lights, self.cfg)
            self._queue_overflow(("shadow", "binsbig"),
                                 torch.stack([s_ovf, s_big]))
        out = framelib.render_frame(
            self._pack.scene, self._packer.pool_for(self.cfg, self.device),
            self._pack.lights, cam_raw, self.params, env, self.cfg,
            self._atlas)
        # dispatch time: the device may still be running the frame
        self.last_frame_ms = (time.perf_counter() - t0) * 1e3
        self.last_output = out
        self.frame_index += 1
        # out.shadow_overflow is a constant 0 when the atlas is cached (every
        # engine frame): fed to the shrink it would oscillate a grown
        # shadow_bin_capacity, so 'shadow' is reported by the atlas alone
        self._queue_overflow(
            ("bins", "binsbig", "tex", "fwdtex", "shadowblk", "skyblk",
             "stream"),
            torch.stack([out.bin_overflow, out.big_overflow,
                         out.tex_overflow[0], out.tex_overflow[1],
                         out.shadow_blocks, out.sky_blocks,
                         out.stream_overflow]))
        if self._settled:
            self._check_overflow()
        return out

    def _tex_block_count(self) -> int:
        """Screen blocks of the frame the tex monitor describes (the
        internal frame under render_scale_pct): the dense-sampling
        threshold of tex_block_capacity growth."""
        cfg = self.cfg
        if cfg.render_scale_pct != 100:
            cfg = framelib.scaled_config(cfg)
        dims = compact.block_dims(cfg.padded_height, cfg.padded_width)
        if dims is None:
            return 0
        return (cfg.padded_height // dims[0]) * (cfg.padded_width // dims[1])

    def _queue_overflow(self, kinds: tuple, values: torch.Tensor) -> None:
        """Queue the fetch of one monitor group, a (len(kinds),) integer
        tensor: one copy to the host."""
        self._overflow_inflight.append((kinds, async_fetch.submit_fetch(
            values.to(torch.int32))))

    def _check_overflow(self, wait: bool = False) -> None:
        """Apply queued monitor fetches, oldest first, as far as they are
        done; never blocks unless ``wait`` (tests: each fetch is waited
        for, with the shrink accounting, unlike ``_settle_sync``). With
        four or more in flight and the oldest not done, the fetches not
        done are dropped: newer frames report the same monitors."""
        while self._overflow_inflight:
            kinds, head = self._overflow_inflight[0]
            if wait and not head.cancelled():
                head.result()
            if not head.done():
                if len(self._overflow_inflight) >= 4:
                    kept = set(map(id, async_fetch.drop_pending(
                        [f for _, f in self._overflow_inflight])))
                    self._overflow_inflight = [
                        (k, f) for k, f in self._overflow_inflight
                        if id(f) in kept]
                break
            self._overflow_inflight.pop(0)
            if head.cancelled():
                continue
            if self._apply_monitor_values(kinds, head.result()):
                return

    def _settle_sync(self) -> bool:
        """Read every queued monitor now (waiting for each copy); True if
        a capacity grew. No shrink accounting: a settling frame is no
        evidence of a long run under low occupancy."""
        while self._overflow_inflight:
            kinds, head = self._overflow_inflight.pop(0)
            if head.cancelled():
                continue
            if self._apply_monitor_values(kinds, head.result(),
                                          shrink=False):
                return True
        return False

    def drain_monitors(self) -> None:
        """Block until every queued monitor fetch has been applied (a
        benchmark must not time a frame under a capacity about to grow)."""
        while self._overflow_inflight:
            self._settle_sync()

    def _apply_monitor_values(self, kinds, vals, shrink: bool = True) -> bool:
        """Grow (or, after SHRINK_AFTER low frames, shrink) capacities from
        one monitor group. True when the config changed: the fetches still
        queued describe the old envelope and are dropped."""
        # the values of one group describe one envelope, and an overflow is
        # a lower bound of its capacity whatever the others say: every
        # overflowed field grows in one config change
        grown = {}
        from_atlas = "shadow" in kinds
        for kind, v in zip(kinds, vals):
            v = int(v)
            if from_atlas and kind == "binsbig":
                self._shadow_big_need = max(v, 1)
            field, label = self._MONITORS[kind]
            cap = getattr(self.cfg, field)
            if cap <= 0:
                continue
            if v > cap:
                if kind in self._BLOCK_KINDS:
                    # 12.5% headroom in 256-block steps: the compacted
                    # work scales with the capacity
                    new_cap = -(-int(v * 1.125) // 256) * 256
                    nb = self._tex_block_count() if kind == "tex" else 0
                    if nb and new_cap >= nb // 2:
                        new_cap = nb      # dense sampling from here on
                else:
                    new_cap = 1 << (v - 1).bit_length()
                log.info("%s %d > %d; growing %s to %d", label, v, cap, field,
                         new_cap)
                self.notifier.push(f"{label} ({v}); capacity grown to {new_cap}",
                                   "warning")
                grown[field] = new_cap
                if kind == "shadow" or (kind == "binsbig" and from_atlas):
                    self._atlas = None   # re-render with the grown capacity
                continue
            floor = getattr(config.RenderConfig(), field)
            if kind == "binsbig":
                need = self._shadow_big_need
                floor = max(floor, 1 << max(need - 1, 1).bit_length())
            if shrink and cap > floor and v < int(cap * 0.4):
                n = self._under_count.get(kind, 0) + 1
                if n >= self.SHRINK_AFTER:
                    if kind in self._BLOCK_KINDS:
                        new_cap = max(floor, -(-max(v, 1) * 2 // 256) * 256)
                    else:
                        new_cap = max(floor, 1 << max(2 * v - 1, 1).bit_length())
                    if new_cap < cap:
                        log.info("%s %d << %d; shrinking %s to %d", label, v,
                                 cap, field, new_cap)
                        grown[field] = new_cap
                        if kind == "shadow":
                            self._atlas = None
                        continue
                    n = 0
                self._under_count[kind] = n
            elif shrink:
                self._under_count[kind] = 0
        if grown:
            self.cfg = replace(self.cfg, **grown)
            self._overflow_inflight.clear()
            self._under_count.clear()
            return True
        return False

    def on_end_frame(self) -> None:
        self.world.on_end_frame()

    def run_frame(self, delta_seconds: float = 0.0) -> framelib.FrameOutput:
        """update -> render -> on_end_frame."""
        self.update(delta_seconds)
        out = self.render()
        self.on_end_frame()
        return out

    def present_numpy(self) -> np.ndarray:
        """The last SDR frame on the host (a frame is run if none was)."""
        if self.last_output is None:
            self.run_frame()
        return self.last_output.sdr.cpu().numpy()

    def resize(self, width: int, height: int) -> None:
        if width == self.cfg.width and height == self.cfg.height:
            return
        self.cfg = replace(self.cfg, width=width, height=height)
        self.camera.resize(width, height)
        self._needs_pack = True

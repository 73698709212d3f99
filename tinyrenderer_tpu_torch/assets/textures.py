"""Texture pool: image loading, default textures, and mip pyramids.

The reference's policy (src/texture.rs:98-252): Albedo/Normal are RGBA8 with
a full mip chain (generated by a compute box filter,
src/mipmap_generator.wgsl), Metalness/Roughness are single-channel taken
from the R channel, HDR is float. Missing material slots fall back to
embedded defaults (src/resource_loader.rs:93-132, 220-224).

TPU-native layout: all material textures are resampled into ONE static pool
``mips[level] : (max_textures, S>>level, S>>level, 4) float32`` so the whole
material system is a single gather inside the jitted frame. Slots 0..3 hold
the default albedo/normal/roughness/metalness.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np

from .. import config

log = logging.getLogger(__name__)

F32 = np.float32

DEFAULT_ALBEDO_SLOT = 0
DEFAULT_NORMAL_SLOT = 1
DEFAULT_ROUGHNESS_SLOT = 2
DEFAULT_METALNESS_SLOT = 3
NUM_DEFAULT_SLOTS = 4


def load_image_rgba(path: str) -> np.ndarray:
    """Load any PIL-supported image as (H, W, 4) float32 in [0, 1]."""
    from PIL import Image
    with Image.open(path) as im:
        im = im.convert("RGBA")
        return np.asarray(im, np.uint8).astype(F32) / 255.0


def resample_to(img: np.ndarray, size: int) -> np.ndarray:
    """Box-resample an (H, W, 4) image to (size, size, 4)."""
    from PIL import Image
    arr = np.clip(img * 255.0, 0, 255).astype(np.uint8)
    im = Image.fromarray(arr, "RGBA").resize((size, size), Image.BILINEAR)
    return np.asarray(im, np.uint8).astype(F32) / 255.0


def box_filter_mip(img: np.ndarray) -> np.ndarray:
    """One 2x2-average mip reduction (mirrors src/shaders/mipmap_generator.wgsl)."""
    h, w = img.shape[:2]
    return img.reshape(h // 2, 2, w // 2, 2, -1).mean(axis=(1, 3)).astype(F32)


def build_mip_chain(img: np.ndarray, levels: int) -> list[np.ndarray]:
    mips = [img.astype(F32)]
    for _ in range(levels - 1):
        mips.append(box_filter_mip(mips[-1]))
    return mips


# -- defaults ----------------------------------------------------------------

def default_albedo(size: int) -> np.ndarray:
    """Solid warm yellow — the dominant color of the reference's embedded
    default albedo (assets/textures/defaults/albedo.png)."""
    img = np.empty((size, size, 4), F32)
    img[...] = np.array([254, 245, 71, 255], F32) / 255.0
    return img


def default_normal(size: int) -> np.ndarray:
    img = np.empty((size, size, 4), F32)
    img[...] = np.array([127, 127, 255, 255], F32) / 255.0
    return img


def default_roughness(size: int) -> np.ndarray:
    return np.ones((size, size, 4), F32)


def default_metalness(size: int) -> np.ndarray:
    img = np.zeros((size, size, 4), F32)
    img[..., 3] = 1.0
    return img


def lightbulb_sprite(size: int) -> np.ndarray:
    """Procedural radial-glow billboard replacing
    assets/textures/defaults/lightbulb.png."""
    ax = (np.arange(size, dtype=F32) + 0.5) / size - 0.5
    r = np.sqrt(ax[:, None] ** 2 + ax[None, :] ** 2) * 2.0
    glow = np.clip(1.0 - r, 0.0, 1.0) ** 2
    core = np.clip(1.0 - r * 3.0, 0.0, 1.0)
    img = np.zeros((size, size, 4), F32)
    img[..., 0] = np.clip(glow * 1.0 + core, 0, 1)
    img[..., 1] = np.clip(glow * 0.9 + core, 0, 1)
    img[..., 2] = np.clip(glow * 0.6 + core, 0, 1)
    img[..., 3] = np.clip(glow * 1.5, 0, 1)
    return img


# -- pool ---------------------------------------------------------------------

@dataclass
class TexturePool:
    """Host-side staging of the device texture pool."""

    size: int
    levels: int
    capacity: int
    mips: list[np.ndarray]          # level -> (capacity, s, s, 4) f32
    slot_of: dict[str, int]         # source key -> slot
    next_slot: int
    # Composite material records: per textured material, one 9-channel
    # texel [albedo rgba | normal rgb | rough | metal] so the whole material
    # reads in ONE gather per tap (TPU gathers cost per *element*, so four
    # separate texture fetches quadruple the dominant frame cost).
    rec_mips: list[np.ndarray]      # level -> (capacity, s, s, 9) f32
    record_of: dict[tuple, int]     # (slots 4-tuple) -> record index
    next_record: int

    RECORD_CHANNELS = 9

    @classmethod
    def create(cls, cfg: config.RenderConfig) -> "TexturePool":
        size, levels, cap = cfg.texture_size, cfg.mip_levels, cfg.max_textures
        mips = [np.zeros((cap, size >> l, size >> l, 4), F32) for l in range(levels)]
        rec_mips = [np.zeros((cap, size >> l, size >> l, cls.RECORD_CHANNELS), F32)
                    for l in range(levels)]
        pool = cls(size=size, levels=levels, capacity=cap, mips=mips,
                   slot_of={}, next_slot=0, rec_mips=rec_mips, record_of={},
                   next_record=0)
        pool._add("default:albedo", default_albedo(size))
        pool._add("default:normal", default_normal(size))
        pool._add("default:roughness", default_roughness(size))
        pool._add("default:metalness", default_metalness(size))
        pool._add("default:lightbulb", lightbulb_sprite(size))
        # record 0: the all-defaults material
        pool.get_or_make_record((DEFAULT_ALBEDO_SLOT, DEFAULT_NORMAL_SLOT,
                                 DEFAULT_ROUGHNESS_SLOT, DEFAULT_METALNESS_SLOT))
        return pool

    def get_or_make_record(self, slots: tuple) -> int:
        """Combine 4 texture slots into one composite record; idempotent."""
        slots = tuple(int(s) for s in slots)
        got = self.record_of.get(slots)
        if got is not None:
            return got
        if self.next_record >= self.capacity:
            raise RuntimeError("material record capacity exceeded; "
                               "grow RenderConfig.max_textures")
        rec = self.next_record
        self.next_record += 1
        self.record_of[slots] = rec
        a, n, r, m = slots
        for l in range(self.levels):
            self.rec_mips[l][rec, ..., 0:4] = self.mips[l][a]
            self.rec_mips[l][rec, ..., 4:7] = self.mips[l][n][..., :3]
            self.rec_mips[l][rec, ..., 7] = self.mips[l][r][..., 0]
            self.rec_mips[l][rec, ..., 8] = self.mips[l][m][..., 0]
        return rec

    def record_arrays(self) -> list[np.ndarray]:
        """Mip arrays trimmed to the used record count (rounded up to a
        small bucket so record additions rarely change the pool shape —
        a shape change retraces, same grow-by-reallocating semantics as
        the other capacities). Shipping all ``max_textures`` slots wasted
        4x pool HBM + H2D on typical scenes (the parity preset's 1024^2
        windowed pool is ~200 MB per 4 records)."""
        bucket = 4
        while bucket < self.next_record:
            bucket *= 2
        bucket = min(bucket, self.capacity)
        return [m[:bucket] for m in self.rec_mips]

    def _add(self, key: str, img: np.ndarray, original=None) -> int:
        if self.next_slot >= self.capacity:
            raise RuntimeError("texture pool capacity exceeded; grow RenderConfig.max_textures")
        slot = self.next_slot
        self.next_slot += 1
        self.slot_of[key] = slot
        chain = build_mip_chain(img, self.levels)
        for l, m in enumerate(chain):
            self.mips[l][slot] = m
        # keep the pre-resample image for the native-size pool
        # (cfg.native_texture_pool; the reference keeps each texture at its
        # own size, src/texture.rs:98-252)
        if not hasattr(self, "originals"):
            self.originals = {}
        self.originals[slot] = img if original is None else original
        return slot

    def get_or_load(self, path: str, usage: str) -> int:
        """Load an image file into a slot (idempotent per path).

        Like the reference, a failed load falls back to the default texture
        of that usage (src/resource_loader.rs:220-224).
        """
        key = f"file:{path}"
        if key in self.slot_of:
            return self.slot_of[key]
        try:
            raw = load_image_rgba(path)
            img = resample_to(raw, self.size)
        except Exception as e:  # missing file -> default
            log.warning("texture load failed (%s): %s; using default", path, e)
            return self.default_slot(usage)
        if usage == "Normal":
            pass  # stored as-is; decode (2x-1) happens at sample time
        elif usage in ("Roughness", "Metalness"):
            img = np.repeat(img[..., :1], 4, axis=-1)  # R channel policy
            raw = np.repeat(raw[..., :1], 4, axis=-1)
        return self._add(key, img, original=raw)

    def default_slot(self, usage: str) -> int:
        return {
            "Albedo": DEFAULT_ALBEDO_SLOT,
            "Normal": DEFAULT_NORMAL_SLOT,
            "Roughness": DEFAULT_ROUGHNESS_SLOT,
            "Metalness": DEFAULT_METALNESS_SLOT,
        }[usage]

    def device_arrays(self) -> list[np.ndarray]:
        return self.mips

    def native_record_chains(self, max_levels: int = 12) -> list:
        """Per composite record, a NATIVE-size 9ch mip chain (the
        reference keeps each texture at its own size with a full chain,
        src/texture.rs:98-252; the fixed pool resamples — lossy for assets
        larger than the pool). A record's size is the max of its four
        sources'; smaller sources upsample (nearest for integer ratios —
        lossless under the box mip chain — else bilinear).

        Returns [rec -> [(h, w, 9) f32 per level]] in record order."""
        originals = getattr(self, "originals", {})
        chains = []
        for slots, rec in sorted(self.record_of.items(), key=lambda kv: kv[1]):
            srcs = [np.asarray(originals.get(s, self.mips[0][s]), F32)
                    for s in slots]
            h = max(s.shape[0] for s in srcs)
            w = max(s.shape[1] for s in srcs)

            def up(img):
                if img.shape[:2] == (h, w):
                    return img
                ry, rx = h // img.shape[0], w // img.shape[1]
                if img.shape[0] * ry == h and img.shape[1] * rx == w:
                    return np.repeat(np.repeat(img, ry, 0), rx, 1)
                from PIL import Image
                arr = np.clip(img * 255.0, 0, 255).astype(np.uint8)
                return np.asarray(
                    Image.fromarray(arr, "RGBA").resize((w, h),
                                                        Image.BILINEAR),
                    np.uint8).astype(F32) / 255.0

            a, n, r, m = (up(s) for s in srcs)
            rec9 = np.concatenate([a[..., :4], n[..., :3], r[..., :1],
                                   m[..., :1]], axis=-1)
            chain = [rec9]
            while (len(chain) < max_levels
                   and chain[-1].shape[0] % 2 == 0
                   and chain[-1].shape[1] % 2 == 0
                   and min(chain[-1].shape[:2]) >= 4):
                chain.append(box_filter_mip(chain[-1]))
            chains.append(chain)
        return chains

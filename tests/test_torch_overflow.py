"""The port's capacity monitors, case for case with tests/test_overflow.py:
an overflow grows the envelope, no silent drop persists, the first frame
handed out is the settled one, and the non-blocking fetches of
``utils/async_fetch``. One parity case holds the port's first frame
against the JAX engine's on the same scene."""

import dataclasses

import numpy as np
import pytest
import torch

from tinyrenderer_tpu.config import RenderConfig as JRenderConfig
from tinyrenderer_tpu.render.engine import Engine as JEngine
from tinyrenderer_tpu.scene import demo as jdemo
from tinyrenderer_tpu.utils import verify
from tinyrenderer_tpu_torch.config import RenderConfig
from tinyrenderer_tpu_torch.render.engine import Engine
from tinyrenderer_tpu_torch.scene import demo
from tinyrenderer_tpu_torch.utils import async_fetch

SMALL_BINS = RenderConfig(
    width=128, height=64, tile_h=16, tile_w=128, bin_capacity=8,
    shadow_size=64, shadow_tile=64, shadow_bin_capacity=256,
    env_size=16, irradiance_size=8, texture_size=32, mip_levels=3,
    max_vertices=8192, max_triangles=4096, max_instances=128,
    use_pallas=False, enable_ssr=False, enable_shadows=False,
)


SMALL_SHADOW_BINS = RenderConfig(
    width=128, height=64, tile_h=16, tile_w=128, bin_capacity=256,
    shadow_size=64, shadow_tile=64, shadow_bin_capacity=8,
    env_size=16, irradiance_size=8, texture_size=32, mip_levels=3,
    max_vertices=8192, max_triangles=4096, max_instances=128,
    use_pallas=False, enable_ssr=False, enable_shadows=True,
)

# test_first_frame_settles_synchronously's scene
SETTLE_CFG = dataclasses.replace(SMALL_BINS, bin_capacity=256,
                                 tex_block_capacity=2)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Six test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _i32(*v) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.int32)


def _engine(cfg, **world) -> Engine:
    return Engine.from_world(demo.build_demo_world(**world),
                             camera=demo.build_demo_camera(128, 64), cfg=cfg,
                             device="cpu")


@pytest.fixture(scope="module")
def jax_first_frame():
    """The JAX engine on SETTLE_CFG's scene after its first frame."""
    je = JEngine.from_world(
        jdemo.build_demo_world(n_cubes=9, textured_every=2),
        camera=jdemo.build_demo_camera(128, 64),
        cfg=JRenderConfig(**dataclasses.asdict(SETTLE_CFG)))
    return je, je.run_frame(0.0)


def test_shadow_bin_overflow_grows_capacity():
    # 40 shadow-casting cubes over a 64px single-tile shadow view with
    # shadow_bin_capacity=8 must overflow and grow
    eng = _engine(SMALL_SHADOW_BINS, n_cubes=40)
    assert eng.cfg.shadow_bin_capacity == 8
    toast_seen = False
    for _ in range(4):
        eng.run_frame(0.0)
        toast_seen = toast_seen or any(
            "Shadow bin overflow" in t.message
            for t in eng.notifier.history())
    assert eng.cfg.shadow_bin_capacity > 8
    assert toast_seen
    for _ in range(4):
        out = eng.run_frame(0.0)
    assert int(out.shadow_overflow) <= eng.cfg.shadow_bin_capacity


def test_bin_overflow_grows_capacity():
    # 40 overlapping cubes in a 128px frame with bin_capacity=8 overflow
    eng = _engine(SMALL_BINS, n_cubes=40)
    assert eng.cfg.bin_capacity == 8
    toast_seen = False
    for _ in range(4):
        eng.run_frame(0.0)
        toast_seen = toast_seen or any(
            "overflow" in t.message for t in eng.notifier.history())
    assert eng.cfg.bin_capacity > 8
    assert toast_seen
    out = eng.run_frame(0.0)
    assert int(out.bin_overflow) <= eng.cfg.bin_capacity


def test_cached_atlas_does_not_feed_shadow_shrink():
    """With a cached atlas, out.shadow_overflow is a 0 sentinel; fed to the
    shrink it would oscillate a grown shadow_bin_capacity. The per-frame
    monitor group omits 'shadow'."""
    eng = _engine(dataclasses.replace(SMALL_SHADOW_BINS,
                                      shadow_bin_capacity=512), n_cubes=4)
    eng.SHRINK_AFTER = 3
    for _ in range(8):  # > SHRINK_AFTER cached-atlas frames
        eng.run_frame(0.0)
    assert eng.cfg.shadow_bin_capacity == 512


def test_repack_rebuilds_pool_on_config_change():
    """A run-time texture_size / mip_levels change rebuilds the packer's
    texture pool."""
    eng = _engine(SMALL_BINS, n_cubes=2)
    eng.run_frame(0.0)
    assert eng._packer.pool.size == SMALL_BINS.texture_size
    eng.cfg = dataclasses.replace(eng.cfg, texture_size=64, mip_levels=4)
    eng._needs_pack = True
    eng.run_frame(0.0)
    assert eng._packer.pool.size == 64
    assert eng._packer.pool.levels == 4


def test_first_frame_settles_synchronously():
    """A fresh engine's very first frame is already right: render() reads
    the monitors of an unsettled frame and renders again until nothing
    grows, so a one-shot render ships no dropped compacted block."""
    eng = _engine(SETTLE_CFG, n_cubes=9, textured_every=2)
    first = eng.run_frame(0.0).sdr.numpy()
    assert eng.cfg.tex_block_capacity > 2  # grew BEFORE the frame returned
    for _ in range(12):
        out = eng.run_frame(0.0)
    assert np.array_equal(first, out.sdr.numpy())


def test_cfg_assignment_rearms_the_settle():
    """A cfg assigned to a settled engine (the viewer's preset or tunable
    switch) whose capacity overflows: the next run_frame renders again,
    grows the capacity before it returns, and hands out the settled
    frame."""
    eng = _engine(dataclasses.replace(SMALL_BINS, bin_capacity=256),
                  n_cubes=40)
    eng.run_frame(0.0)
    assert eng._settled
    eng.cfg = dataclasses.replace(eng.cfg, bin_capacity=8)
    assert not eng._settled
    f0 = eng.frame_index
    first = eng.run_frame(0.0)
    assert eng.frame_index - f0 > 1           # rendered again
    assert eng._settled and eng.cfg.bin_capacity > 8
    assert int(first.bin_overflow) <= eng.cfg.bin_capacity
    grown = eng.cfg
    out = eng.run_frame(0.0)
    assert eng.cfg == grown
    assert torch.equal(first.pick_id, out.pick_id)
    assert torch.equal(first.sdr, out.sdr)


def test_first_frame_matches_jax_engine(jax_first_frame):
    """One run_frame on each side of the settle scene: the same grown
    config field by field, equal pick ids, the SDR within the port's frame
    bar (tests/test_torch_frame.py: the edge-aware comparator)."""
    je, j_out = jax_first_frame
    eng = _engine(SETTLE_CFG, n_cubes=9, textured_every=2)
    out = eng.run_frame(0.0)
    assert eng.cfg.tex_block_capacity > 2
    assert dataclasses.asdict(eng.cfg) == dataclasses.asdict(je.cfg)
    jp = np.asarray(j_out.pick_id)
    assert np.array_equal(out.pick_id.numpy(), jp)
    res = verify.edge_aware_compare(out.sdr.numpy(), np.asarray(j_out.sdr),
                                    pick=jp)
    assert res["status"] == "pass", res


def test_multi_field_overflow_grows_in_one_config_change():
    """Two overflowed fields of one monitor group grow in one config
    change, not one a frame."""
    eng = Engine(cfg=RenderConfig(tex_block_capacity=2, fwd_tile_capacity=2),
                 device="cpu")
    configs_seen = {id(eng.cfg)}
    eng._queue_overflow(("tex", "fwdtex"), _i32(300, 40))
    eng._check_overflow(wait=True)
    configs_seen.add(id(eng.cfg))
    assert eng.cfg.tex_block_capacity >= 300
    assert eng.cfg.fwd_tile_capacity >= 40
    assert len(configs_seen) == 2  # exactly one replace() applied both


def test_capacity_shrinks_after_sustained_underuse():
    """After SHRINK_AFTER consecutive frames under 40% occupancy the
    envelope re-buckets down (never below the config-default floor); a
    spike resets the streak."""
    eng = Engine(cfg=RenderConfig(tex_block_capacity=2048), device="cpu")
    eng.SHRINK_AFTER = 5
    for _ in range(4):
        eng._queue_overflow(("tex",), _i32(10))
        eng._check_overflow(wait=True)
    assert eng.cfg.tex_block_capacity == 2048  # hysteresis holds
    eng._queue_overflow(("tex",), _i32(10))
    eng._check_overflow(wait=True)
    assert eng.cfg.tex_block_capacity == RenderConfig().tex_block_capacity

    eng.cfg = dataclasses.replace(eng.cfg, tex_block_capacity=2048)
    for _ in range(4):
        eng._queue_overflow(("tex",), _i32(10))
        eng._check_overflow(wait=True)
    eng._queue_overflow(("tex",), _i32(1500))
    eng._check_overflow(wait=True)
    eng._queue_overflow(("tex",), _i32(10))
    eng._check_overflow(wait=True)
    assert eng.cfg.tex_block_capacity == 2048


def test_shadow_big_need_floors_binsbig_shrink():
    """bin_big_capacity grown for the shadow pass is not shrunk by the
    camera raster's low occupancy; when the shadow need drops, the floor
    follows and the shrink works."""
    eng = Engine(cfg=RenderConfig(), device="cpu")
    eng.SHRINK_AFTER = 3
    eng._queue_overflow(("shadow", "binsbig"), _i32(10, 200))
    eng._check_overflow(wait=True)
    assert eng.cfg.bin_big_capacity == 256        # grown past the need
    assert eng._atlas is None                     # atlas-time overflow
    for _ in range(10):
        eng._queue_overflow(("binsbig",), _i32(5))
        eng._check_overflow(wait=True)
    assert eng.cfg.bin_big_capacity == 256

    eng._queue_overflow(("shadow", "binsbig"), _i32(10, 20))
    eng._check_overflow(wait=True)
    for _ in range(10):
        eng._queue_overflow(("binsbig",), _i32(5))
        eng._check_overflow(wait=True)
    assert eng.cfg.bin_big_capacity == RenderConfig().bin_big_capacity


def test_camera_binsbig_growth_keeps_cached_atlas():
    """A big-triangle overflow of the camera raster grows the capacity but
    keeps the cached atlas; only an atlas-time overflow re-renders it."""
    eng = Engine(cfg=RenderConfig(), device="cpu")
    sentinel = object()
    eng._atlas = sentinel
    eng._queue_overflow(("binsbig",), _i32(eng.cfg.bin_big_capacity + 1))
    eng._check_overflow(wait=True)
    assert eng.cfg.bin_big_capacity > RenderConfig().bin_big_capacity
    assert eng._atlas is sentinel


# ---- utils/async_fetch ----------------------------------------------------

class _Pending:
    """A fetch whose copy has not completed until ``finish``."""

    def __init__(self, value):
        self.value, self.finished, self._cancelled = value, False, False

    def finish(self):
        self.finished = True

    def done(self):
        return self.finished or self._cancelled

    def result(self):
        assert self.finished and not self._cancelled
        return self.value

    def cancel(self):
        if self.done():
            return self._cancelled
        self._cancelled = True
        return True

    def cancelled(self):
        return self._cancelled


def test_cpu_fetch_is_ready_at_once():
    t = _i32(3, 1, 4)
    f = async_fetch.submit_fetch(t)
    t[0] = 9                                   # the fetch holds a copy
    assert f.done() and not f.cancelled()
    assert f.result().tolist() == [3, 1, 4]
    assert f.cancel() is False and not f.cancelled()
    assert async_fetch.drop_pending([f]) == [f]


def test_drop_pending_keeps_what_is_done():
    a, b, c = _Pending(1), _Pending(2), _Pending(3)
    b.finish()
    assert async_fetch.drop_pending([a, b, c]) == [b]
    assert a.cancelled() and c.cancelled() and not b.cancelled()


def test_steady_frames_hold_four_fetches_in_flight():
    """A settled engine whose fetches never complete keeps at most four in
    flight (the older ones are dropped, never applied), applies a fetch
    once it is done, and drain_monitors leaves the queue empty."""
    eng = Engine(cfg=RenderConfig(), device="cpu")
    eng._settled = True
    fetches = []
    for i in range(10):
        f = _Pending([10])
        fetches.append(f)
        eng._overflow_inflight.append((("tex",), f))
        eng._check_overflow()
        assert len(eng._overflow_inflight) <= 4
    assert sum(f.cancelled() for f in fetches) >= 6
    live = [f for _, f in eng._overflow_inflight]
    for f in live:
        f.finish()
    eng._queue_overflow(("tex",), _i32(RenderConfig().tex_block_capacity + 1))
    eng._check_overflow()
    assert not eng._overflow_inflight
    assert eng.cfg.tex_block_capacity > RenderConfig().tex_block_capacity
    assert eng._settled is False              # a growth re-arms the settle
    eng._queue_overflow(("tex",), _i32(5))
    eng.drain_monitors()
    assert not eng._overflow_inflight

"""The port's single-card entry against the reference's: ``fn(*args)`` of
``__graft_entry__.entry()`` under ``jax.jit`` and of the port's
``entry("cpu")`` at ``small_config()`` render the same frame (equal pick
ids and depth, SDR within the repo's edge-aware comparator), on the demo
world the reference falls back to and on ``levels/demo.lvl``."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import planes
import pytest
import torch

import __graft_entry__ as graft
from tinyrenderer_tpu.render import frame as jframe
from tinyrenderer_tpu.render.engine import Engine as JEngine
from tinyrenderer_tpu.utils import verify
from tinyrenderer_tpu_torch import entry as tentry

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LEVEL = os.path.join(ROOT, "levels", "demo.lvl")


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Six test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jax_level_entry(level_path):
    """The reference entry's steps on a level (its ``_build_engine`` takes
    test.lvl when it exists)."""
    eng = JEngine(cfg=graft._small_cfg(), level_path=level_path)
    eng.update(0.0)
    eng._drain_actions()
    env = eng._ensure_env()
    cfg = eng.cfg

    def fn(scene, pool, lights, camera_raw, params):
        return jframe.render_frame(scene, pool, lights, camera_raw, params,
                                   env, cfg)

    return fn, (eng._pack.scene, eng._packer.pool_for(cfg), eng._pack.lights,
                jnp.asarray(eng.camera.to_raw()), eng.params)


def _agree(j_out, render, min_ids):
    """``render()``'s frame under the JAX package's rounding of the raster
    planes equals the JAX frame; the port's own frame is held to it by
    ``planes.hold_frame`` (tests/planes.py). Returns the port's own
    frame."""
    under_jax, port, f64 = planes.three(render)
    planes.hold_frame(port, j_out, f64)
    t_out = under_jax
    jp = np.asarray(j_out.pick_id)
    assert np.array_equal(t_out.pick_id.numpy(), jp)
    assert np.array_equal(t_out.depth.numpy(), np.asarray(j_out.depth))
    res = verify.edge_aware_compare(t_out.sdr.numpy(), np.asarray(j_out.sdr),
                                    pick=jp)
    assert res["status"] == "pass", res
    assert len(np.unique(jp)) >= min_ids and (jp == 0).any()
    return port


def test_small_config_is_the_reference_entry_config():
    assert (dataclasses.asdict(tentry.small_config())
            == dataclasses.asdict(graft._small_cfg()))


def test_entry_frame_matches_the_reference_entry():
    """The demo world under the default camera (the reference's fallback
    without its level): two objects and the sky in view."""
    j_fn, j_args = graft.entry()
    j_out = jax.jit(j_fn)(*j_args)
    t_fn, t_args = tentry.entry("cpu")
    assert all(not isinstance(a, torch.Tensor) or a.device.type == "cpu"
               for a in t_args)
    t_out = _agree(j_out, lambda: t_fn(*t_args), 3)
    assert t_out.sdr.shape == (128, 256, 3)
    # the same function again on the same arguments: the same frame
    again = t_fn(*t_args)
    assert torch.equal(again.sdr, t_out.sdr)


def test_entry_on_a_level_matches_the_reference_steps():
    """``level_path``: demo.lvl's two lights (seven shadow views) and its
    billboard, through the overlay."""
    j_fn, j_args = _jax_level_entry(LEVEL)
    j_out = jax.jit(j_fn)(*j_args)
    t_fn, t_args = tentry.entry("cpu", level_path=LEVEL)
    _agree(j_out, lambda: t_fn(*t_args), 4)


def test_entry_cli(capsys):
    """``python -m tinyrenderer_tpu_torch.entry``: the frame on the CPU;
    without a card the default device is refused."""
    assert tentry.main(["--device", "cpu"]) == 0
    assert "sdr (128, 256, 3)" in capsys.readouterr().out
    if not torch.cuda.is_available():
        assert tentry.main([]) == 1

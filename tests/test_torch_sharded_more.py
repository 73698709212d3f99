"""The rest of tests/test_torch_sharded.py's whole-frame cases (stream +
bf16, SSR, render scale, the compacted sky), the sky-block monitor, the
steady frame over a kept atlas, a rank's failure and the dryrun entry
point, in a file of their own so that --dist loadfile runs them beside the
first half. The port's sharded frame over four gloo ranks on the CPU
against JAX ``compiled_sharded_frame`` and the port's single-card
frame."""

import dataclasses
import json
import os
import subprocess
import sys

import pytest

from test_torch_sharded import (MORE_CASES, TINY, _port, _single,  # noqa: F401
                                check_matches_jax, check_matches_single_card,
                                few_threads, make_world)
from tinyrenderer_tpu_torch.parallel import jobs
from tinyrenderer_tpu_torch.parallel.launch import launch


@pytest.fixture(scope="module")
def world():
    return make_world(MORE_CASES + ["cached_atlas"])


@pytest.mark.parametrize("case", MORE_CASES)
def test_sharded_frame_matches_jax(world, case):
    check_matches_jax(world, case)


@pytest.mark.parametrize("case", MORE_CASES)
def test_sharded_frame_matches_single_card(world, case):
    check_matches_single_card(world, case)


def test_sharded_sky_block_monitor(world):
    """ShardedFrameOutput.sky_blocks, a frame's bands' background blocks
    summed, equals the single-card frame's monitor under
    sky_block_capacity=4096 (the JAX sharded frame drops it)."""
    out = _port(world, "compact_sky")["out"]
    single = _single(world, "compact_sky")
    assert int(single.sky_blocks) > 0
    assert int(out["sky_blocks"]) == int(single.sky_blocks)
    assert int(_port(world, "ssr")["out"]["sky_blocks"]) == 0


def test_rank_failure_raises_with_its_traceback():
    """A rank that raises makes launch raise with that rank's traceback
    (here: the grid does not fit the world)."""
    job = dict(device="cpu", backend="gloo", worlds=[dict(
        world=("demo", {}), cfg=dataclasses.asdict(TINY),
        cases=[dict(name="bad", cfg=dataclasses.asdict(TINY), dp=3)])])
    with pytest.raises(RuntimeError, match=r"rank \d failed:(.|\n)*dp=3"):
        launch(jobs.frame_job, 2, "gloo", "cpu", job, timeout_s=120)


def test_cached_atlas_frame(world):
    """The steady frame: the atlas rendered once by
    render_shadow_atlas_sharded and passed in gives the single-card frame
    under the base bars; its shadow bins are monitored at atlas time."""
    check_matches_single_card(world, "cached_atlas")
    assert int(_port(world, "cached_atlas")["out"]["shadow_overflow"]) == 0


def test_parallel_entry_on_the_cpu():
    """``python -m tinyrenderer_tpu_torch.parallel`` (the dryrun's two
    steps over four gloo ranks, dp=2) on the host: exit 0 and one line a
    step with the frame's shape."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run(
        [sys.executable, "-m", "tinyrenderer_tpu_torch.parallel", "--ranks",
         "4", "--backend", "gloo", "--device", "cpu"], cwd=root,
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert res.returncode == 0, res.stderr[-3000:]
    steps = [json.loads(ln) for ln in res.stdout.splitlines()
             if ln.startswith("{")]
    assert [s["step"] for s in steps] == ["ssr_stream", "fused_shading"]
    assert all(s["frame"] == [2, 128, 256, 3] and s["dp"] == 2
               for s in steps)


"""The port's fidelity report against the JAX engine, on ``levels/demo.lvl``
(``tests/test_torch_fidelity_textured.py`` runs the same cases on the
textured demo world): ``main([... "--only", "default,performance_preset"])``
at 160x96 on the CPU. Each configuration's frame passes the repo's
edge-aware comparator against the JAX engine's settled first frame of the
same configuration, and the report's rows agree with the rows the
reference tool's formulas give on those JAX frames (the reference tool
itself needs test.lvl)."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from tinyrenderer_tpu.config import RenderConfig as JRenderConfig
from tinyrenderer_tpu.render.engine import Engine as JEngine
from tinyrenderer_tpu.scene import demo as jdemo
from tinyrenderer_tpu.utils import verify
from tinyrenderer_tpu_torch.config import RenderConfig
from tinyrenderer_tpu_torch.tools import fidelity_report

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LEVEL = os.path.join(ROOT, "levels", "demo.lvl")
# the presets test's small envelope
BASE = RenderConfig(width=160, height=96, tile_h=16, tile_w=128,
                    bin_capacity=128, shadow_size=128, shadow_tile=128,
                    shadow_bin_capacity=128, env_size=32, irradiance_size=8,
                    texture_size=64, mip_levels=4)
ONLY = ("default", "performance_preset")
# bars between the report's rows and the rows of the JAX frames: the two
# frames of a configuration may differ by an LSB on a few pixels (the
# edge-aware comparator's allowance), which moves a row's numbers a little
PSNR_DB, OVER_1_PCT, OVER_4_PCT = 1.0, 0.5, 0.1


@pytest.fixture(scope="module")
def world():
    return "level"


@pytest.fixture(scope="module")
def report(world, tmp_path_factory):
    """The port's rows, timed over one round of two frames, PNGs saved."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    out = tmp_path_factory.mktemp("fidelity")
    try:
        rows = fidelity_report.main(
            ["--device", "cpu", "--world", world, "--level", LEVEL,
             "--width", "160", "--height", "96", "--only", ",".join(ONLY),
             "--time", "1", "--frames", "2", "--save-dir", str(out)],
            base=BASE)
    finally:
        torch.set_num_threads(n)
    return rows, out


@pytest.fixture(scope="module")
def jax_frames(world):
    """The JAX engine's settled first frame (SDR, pick ids) of each
    configuration, on the same scene, built from the JAX package."""
    frames = {}
    for name, cfg in fidelity_report.configurations(BASE).items():
        if name not in ONLY + (fidelity_report.BASELINE,):
            continue
        jcfg = JRenderConfig(**dataclasses.asdict(cfg))
        if world == "textured":
            eng = JEngine.from_world(
                jdemo.build_demo_world(n_cubes=24, textured_every=2),
                camera=jdemo.build_demo_camera(160, 96), cfg=jcfg)
        else:
            eng = JEngine(cfg=jcfg, level_path=LEVEL)
        out = eng.run_frame(0.0)
        frames[name] = (np.asarray(out.sdr), np.asarray(out.pick_id))
    return frames


def test_report_rows_and_files(report):
    rows, out = report
    assert [r["config"] for r in rows] == ["reference_parity", *ONLY]
    assert rows[0]["psnr_db"] == float("inf")
    assert rows[0]["over_1_lsb_pct"] == rows[0]["over_4_lsb_pct"] == 0.0
    for r in rows:
        assert r["sdr"].shape == (96, 160, 3) and r["sdr"].dtype == np.uint8
        assert r["ms_per_frame"] > 0
        assert os.path.getsize(out / f"{r['config']}.png") > 0
    lines = fidelity_report.table(rows)
    assert lines[0].endswith("ms/frame |") and len(lines) == 2 + len(rows)
    assert lines[2].startswith("| reference_parity | exact | 0.00% | 0.00% |")


def test_frames_match_the_jax_engine(report, jax_frames):
    for r in report[0]:
        sdr, pick = jax_frames[r["config"]]
        res = verify.edge_aware_compare(r["sdr"], sdr, pick=pick)
        assert res["status"] == "pass", (r["config"], res)
        assert len(np.unique(pick)) > 2 and (pick == 0).any()


def test_rows_match_the_rows_of_the_jax_frames(report, jax_frames):
    """The reference tool's formulas on the JAX frames: PSNR over the SDR
    frame, and the share of pixels with any channel more than 1 and more
    than 4 LSB off reference_parity."""
    ref = jax_frames[fidelity_report.BASELINE][0].astype(np.float64)
    for r in report[0]:
        img = jax_frames[r["config"]][0].astype(np.float64)
        mse = ((img - ref) ** 2).mean()
        p = float("inf") if mse == 0 else 10.0 * np.log10(255.0 ** 2 / mse)
        d = np.abs(img - ref).max(axis=-1)
        if p == float("inf"):
            assert r["psnr_db"] == p, r["config"]
        else:
            assert abs(r["psnr_db"] - p) <= PSNR_DB, (r["config"], p)
        assert abs(r["over_1_lsb_pct"] - 100.0 * (d > 1).mean()) <= OVER_1_PCT
        assert abs(r["over_4_lsb_pct"] - 100.0 * (d > 4).mean()) <= OVER_4_PCT


def test_only_keeps_the_baseline_and_refuses_unknown_names():
    names = fidelity_report.configurations(BASE)
    assert len(names) == 20 and "default_sky4_cubic" in names
    with pytest.raises(SystemExit):
        fidelity_report.main(["--device", "cpu", "--only", "no_such_config"],
                             base=BASE)
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit) as e:
            fidelity_report.main([])
        assert e.value.code == 1

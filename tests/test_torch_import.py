"""The port imports torch and never jax, and CPU tensors never reach the
CUDA kernel library."""

import subprocess
import sys

import numpy as np
import torch

from tinyrenderer_tpu_torch import kernels
from tinyrenderer_tpu_torch.ops import raster, resolve, shading

PORT_MODULES = [
    "tinyrenderer_tpu_torch", "tinyrenderer_tpu_torch.kernels",
    "tinyrenderer_tpu_torch.shared",
    "tinyrenderer_tpu_torch.ops.fp", "tinyrenderer_tpu_torch.ops.raster",
    "tinyrenderer_tpu_torch.ops.resolve", "tinyrenderer_tpu_torch.ops.compact",
    "tinyrenderer_tpu_torch.ops.shadows", "tinyrenderer_tpu_torch.ops.sampling",
    "tinyrenderer_tpu_torch.ops.env", "tinyrenderer_tpu_torch.ops.post",
    "tinyrenderer_tpu_torch.ops.shading",
    "tinyrenderer_tpu_torch.render.scene_gpu",
    "tinyrenderer_tpu_torch.render.frame",
    "tinyrenderer_tpu_torch.render.engine",
]


def test_port_never_imports_jax():
    code = ("import importlib, sys\n"
            f"for m in {PORT_MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith("
            "('jax.', 'jaxlib', 'tinyrenderer_tpu.render', 'tinyrenderer_tpu.ops',"
            " 'tinyrenderer_tpu.parallel')))\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr


def test_cpu_tensors_take_plain_versions():
    """The wrappers run their plain versions on CPU tensors: no build, no
    library, no launch counted."""
    rng = np.random.default_rng(0)
    rows = torch.zeros((1, 2, 8, 16))          # empty bins: id 0 rows
    bins = raster.Bins(ids=torch.full((1, 2, 8), -1, dtype=torch.int32),
                       rows=rows, counts=torch.full((1, 2), 8, dtype=torch.int32),
                       overflow=torch.tensor(8), big_overflow=torch.tensor(0))
    tid, depth = raster.rasterize_binned(bins, 8, 128)
    assert tid.shape == (8, 256) and (tid == -1).all() and (depth == 0).all()
    table = torch.from_numpy(rng.standard_normal((4, resolve.ROW_D_SLIM),
                                                 dtype=np.float32))
    outf, outh = resolve.select_eval(torch.zeros((8, 16), dtype=torch.int32),
                                     table)
    assert outf.shape == (4, 8, 16) and outh.dtype == torch.bfloat16
    lights = shading.ShadingLights(*(torch.ones(1, 3),) * 4,
                                   dir_viewproj=torch.eye(4)[None])
    hdr = shading.shade_deferred_fused(
        torch.zeros((8, 16), dtype=torch.int32), outf, outh,
        torch.ones((2, 8, 16)), None, torch.zeros(3), lights, 1, 1, None)
    assert hdr.shape == (3, 8, 16) and torch.isfinite(hdr).all()
    assert kernels._lib is None
    assert (raster.K1_LAUNCHES, resolve.K2_LAUNCHES, shading.K3_LAUNCHES) == (0, 0, 0)

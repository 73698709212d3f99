"""The port imports torch and never jax nor anything of the JAX package
(it keeps its own copies of the JAX-free modules), and CPU tensors never
reach the CUDA kernel library."""

import ast
import os
import pkgutil
import subprocess
import sys

import numpy as np
import torch

import tinyrenderer_tpu_torch
from tinyrenderer_tpu_torch import kernels
from tinyrenderer_tpu_torch.ops import raster, resolve, sampling, shading

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_MODULES = ["tinyrenderer_tpu_torch"] + sorted(
    m.name for m in pkgutil.walk_packages(tinyrenderer_tpu_torch.__path__,
                                          "tinyrenderer_tpu_torch."))
FORBIDDEN = ("jax", "jaxlib", "tinyrenderer_tpu")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_port_never_imports_jax():
    """Every module of the port, the copies of the JAX-free modules
    included, imports in a fresh interpreter without jax, jaxlib or any
    module of the JAX package entering sys.modules."""
    assert {"tinyrenderer_tpu_torch.config",
            "tinyrenderer_tpu_torch.scene.demo",
            "tinyrenderer_tpu_torch.assets.native",
            "tinyrenderer_tpu_torch.utils.verify"} <= set(PORT_MODULES)
    assert "tinyrenderer_tpu_torch.shared" not in PORT_MODULES
    code = ("import importlib, sys\n"
            f"for m in {PORT_MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            f"bad = sorted(m for m in sys.modules if any(m == f or "
            f"m.startswith(f + '.') for f in {FORBIDDEN!r}))\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert res.returncode == 0, res.stderr


def test_chip_smoke_never_imports_jax():
    """chip_smoke.py names neither jax nor the JAX package in any import
    statement (read from its syntax tree, not run: it needs a card)."""
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
    assert "tinyrenderer_tpu_torch.render.engine" in names
    assert not [n for n in names if _forbidden(n)], names


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
    tid, depth, sel = raster.rasterize_resolve_binned(
        bins, torch.ones((3, resolve.ROW_D)), 8, 128)
    assert sel.shape == (8, 256, resolve.ROW_D) and (sel == 0).all()
    table = torch.from_numpy(rng.standard_normal((4, resolve.ROW_D_SLIM),
                                                 dtype=np.float32))
    outf, outh = resolve.select_eval(torch.zeros((8, 16), dtype=torch.int32),
                                     table)
    assert outf.shape == (4, 8, 16) and outh.dtype == torch.bfloat16
    lights = shading.ShadingLights(*(torch.ones(1, 3),) * 4,
                                   dir_viewproj=torch.eye(4)[None])
    hdr = shading.shade_deferred_fused(
        torch.zeros((8, 16), dtype=torch.int32), outf, outh, None,
        torch.ones((2, 8, 16)), None, torch.zeros(3), lights, 1, 1, None)
    assert hdr.shape == (3, 8, 16) and torch.isfinite(hdr).all()
    tap = sampling.windowed_blend(torch.zeros((4, 36), dtype=torch.uint8),
                                  torch.arange(4, dtype=torch.int32),
                                  torch.zeros(4), torch.zeros(4), 9)
    assert tap.shape == (4, 9) and (tap == 0).all()
    assert kernels._lib is None
    assert (raster.K1_LAUNCHES, resolve.K2_LAUNCHES, shading.K3_LAUNCHES,
            raster.K6_LAUNCHES, sampling.K7_LAUNCHES) == (0, 0, 0, 0, 0)

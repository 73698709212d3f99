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
# the editor, its host surfaces and the entry points
HOST_MODULES = ["tinyrenderer_tpu_torch." + m for m in (
    "editor.events", "editor.gizmo", "editor.controller", "editor.picking",
    "editor.session", "render.global_params", "render.reload",
    "utils.notify", "utils.containers", "utils.image_io", "viewer.server",
    "viewer.__main__", "__main__", "parallel.sharded", "parallel.launch",
    "parallel.__main__", "tools.orbit", "utils.async_fetch", "entry",
    "tools.gen_default_ibl", "tools.fidelity_report", "bench")]
# the measurement tools (they import neither jax, the JAX package nor the
# repository's root tools/)
TOOL_MODULES = ["tinyrenderer_tpu_torch.tools." + m for m in (
    "timing", "bench_stages", "profile_highpoly", "trace_top",
    "profile_frame", "ab_frame", "bench_binning", "bench_sky_blocks",
    "bench_gather_pcf", "dump_graph")]


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_port_never_imports_jax():
    """Every module of the port, the copies of the JAX-free modules
    included, imports in a fresh interpreter without jax, jaxlib or any
    module of the JAX package entering sys.modules."""
    assert {"tinyrenderer_tpu_torch.config",
            "tinyrenderer_tpu_torch.scene.demo",
            "tinyrenderer_tpu_torch.assets.native",
            "tinyrenderer_tpu_torch.utils.verify",
            "tinyrenderer_tpu_torch.editor.session",
            "tinyrenderer_tpu_torch.viewer.server",
            "tinyrenderer_tpu_torch.__main__",
            "tinyrenderer_tpu_torch.parallel.sharded",
            "tinyrenderer_tpu_torch.parallel.launch",
            "tinyrenderer_tpu_torch.parallel.__main__",
            "tinyrenderer_tpu_torch.utils.async_fetch",
            "tinyrenderer_tpu_torch.tools.orbit",
            "tinyrenderer_tpu_torch.entry",
            "tinyrenderer_tpu_torch.tools.gen_default_ibl",
            "tinyrenderer_tpu_torch.tools.fidelity_report",
            "tinyrenderer_tpu_torch.ops.fp",
            "tinyrenderer_tpu_torch.bench"} | set(TOOL_MODULES) <= set(
                PORT_MODULES)
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


def test_tools_never_import_the_reference_tools():
    """The measurement tools import, in a fresh interpreter run from the
    repository's root, without jax, the JAX package, the root ``tools/``
    or the root ``bench.py`` entering sys.modules; no import statement of
    theirs names any of them (read from their syntax trees)."""
    assert set(TOOL_MODULES) <= set(PORT_MODULES)
    code = ("import importlib, sys\n"
            f"for m in {TOOL_MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'tinyrenderer_tpu', 'tools', 'bench'))\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert res.returncode == 0, res.stderr
    for m in TOOL_MODULES:
        path = os.path.join(ROOT, *m.split(".")) + ".py"
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     and node.level == 0 else [])
            for n in names:
                assert n.split(".")[0] not in ("jax", "jaxlib",
                                               "tinyrenderer_tpu", "tools",
                                               "bench"), (m, n)


def test_host_surfaces_need_no_pil():
    """The editor, its host surfaces and the entry points are walked, and
    they import without PIL: encoding a PNG or a GIF, saving one and
    serving the viewer's page need none (the card's machine has no PIL)."""
    assert set(HOST_MODULES) <= set(PORT_MODULES)
    code = ("import builtins, importlib, sys\n"
            "real = builtins.__import__\n"
            "def guard(name, *a, **k):\n"
            "    if name == 'PIL' or name.startswith('PIL.'):\n"
            "        raise ImportError('PIL is not on the card machine')\n"
            "    return real(name, *a, **k)\n"
            "builtins.__import__ = guard\n"
            f"for m in {HOST_MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "import numpy as np, tempfile, os\n"
            "from tinyrenderer_tpu_torch.utils import image_io\n"
            "from tinyrenderer_tpu_torch.assets import native\n"
            "img = np.zeros((4, 5, 3), np.uint8)\n"
            "native.encode_png = lambda a: None\n"
            "assert image_io.encode_png(img)[:4] == b'\\x89PNG'\n"
            "p = os.path.join(tempfile.mkdtemp(), 'a.png')\n"
            "image_io.save_png(p, img)\n"
            "assert image_io.encode_gif([img, img])[:6] == b'GIF89a'\n"
            "assert 'PIL' not in sys.modules\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert res.returncode == 0, res.stderr


def test_spawned_rank_never_imports_jax():
    """A rank that parallel.launch spawns from this test process (which has
    imported jax) imports the port's whole frame to run its target and
    holds neither jax nor any module of the JAX package."""
    from tinyrenderer_tpu_torch.parallel import jobs
    from tinyrenderer_tpu_torch.parallel.launch import launch
    assert "jax" in sys.modules
    loaded = launch(jobs.loaded_modules, 1, "gloo", "cpu", timeout_s=120)[0]
    assert "tinyrenderer_tpu_torch" in loaded and "torch" in loaded
    assert not [m for m in loaded if _forbidden(m)], loaded


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


def test_fp_kernels_module_imports_no_reference():
    """``ops/fp.py`` (the glue kernels' wrappers and plain versions) and
    the kernel library's ``kernels.py`` import, by their syntax trees, the
    standard library, numpy, torch and the port's own modules: nothing of
    jax or the JAX package."""
    allowed = {"__future__", "contextlib", "ctypes", "fractions", "hashlib",
               "math", "os", "pathlib", "shutil", "struct", "subprocess",
               "time", "typing", "numpy", "torch", ".."}
    for rel in ("ops/fp.py", "kernels.py"):
        with open(os.path.join(ROOT, "tinyrenderer_tpu_torch", rel)) as f:
            tree = ast.parse(f.read())
        names = []
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names += [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names.append("." * node.level + (node.module or ""))
        assert set(names) <= allowed, (rel, names)
        assert not [n for n in names if _forbidden(n)], (rel, names)


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

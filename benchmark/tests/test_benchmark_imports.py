"""Nothing the benchmark runs imports JAX or the JAX package, the plain
reference imports nothing of the port, and nothing reads the repository's
root ``bench.py`` or ``tools/``. Top-level module names are compared
whole: ``tinyrenderer_tpu_torch`` is the port, ``tinyrenderer_tpu`` the
JAX package."""

import ast
import os
import subprocess
import sys

from benchmark import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "tinyrenderer_tpu"}
ROOT_ONLY = {"bench", "tools", "chip_smoke"}


def _modules():
    for dirpath, _, files in os.walk(harness.BENCH_DIR):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _imports(path):
    """Top-level names of every absolute import of a module."""
    tree = ast.parse(open(path, encoding="utf-8").read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".", 1)[0]


def test_no_module_imports_jax_or_the_jax_package():
    for path in _modules():
        if os.sep + "tests" + os.sep in path:
            continue
        bad = set(_imports(path)) & (FORBIDDEN | ROOT_ONLY)
        assert not bad, f"{path} imports {bad}"


def test_the_tests_import_neither_jax_nor_the_root_tools():
    for path in _modules():
        bad = set(_imports(path)) & (FORBIDDEN | ROOT_ONLY)
        assert not bad, f"{path} imports {bad}"


def test_reference_imports_nothing_of_the_port():
    ref = os.path.join(harness.BENCH_DIR, "reference")
    for f in os.listdir(ref):
        if f.endswith(".py"):
            names = set(_imports(os.path.join(ref, f)))
            assert not names & {"tinyrenderer_tpu_torch", "benchmark"}, f
            tree = ast.parse(open(os.path.join(ref, f)).read())
            rel = [n for n in ast.walk(tree)
                   if isinstance(n, ast.ImportFrom) and n.level > 1]
            assert not rel, f"{f} imports outside the reference"


def _strings(path):
    """The string constants of a module's code, docstrings left out."""
    tree = ast.parse(open(path, encoding="utf-8").read())
    docs = {id(n.body[0].value) for n in ast.walk(tree)
            if isinstance(n, (ast.Module, ast.FunctionDef, ast.ClassDef))
            and n.body and isinstance(n.body[0], ast.Expr)}
    return [n.value for n in ast.walk(tree) if isinstance(n, ast.Constant)
            and isinstance(n.value, str) and id(n) not in docs]


def test_no_module_reads_the_root_records():
    for path in _modules():
        if os.sep + "tests" + os.sep in path:
            continue
        for s in _strings(path):
            for name in ("BENCH_", "MULTICHIP_", "chip_smoke", "bench.py",
                         "tools/"):
                assert name not in s, f"{path} names {name}: {s!r}"


def test_sys_modules_after_a_cpu_rehearsal(tmp_path):
    """A CPU run of one tiny cell in a fresh process loads neither JAX nor
    the JAX package."""
    code = (
        "import json, sys\n"
        "from benchmark import harness\n"
        "from benchmark.tests import fixtures\n"
        "harness.QUIET_FRAMES = 1\n"
        f"m = fixtures.write_tiny({str(tmp_path)!r}, cubes=4)\n"
        "harness.run('tiny_deferred_1080p.orbit', 5, 0.2, False, device='cpu',"
        f" manifest=m, search=[{str(tmp_path)!r}], log=lambda *a: None)\n"
        "print(json.dumps(sorted({k.split('.', 1)[0] for k in sys.modules})))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                       capture_output=True, text=True, timeout=600,
                       env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert r.returncode == 0, r.stderr[-3000:]
    loaded = set(__import__("json").loads(r.stdout.strip().splitlines()[-1]))
    assert "tinyrenderer_tpu_torch" in loaded
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN

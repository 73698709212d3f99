"""The port's host surfaces against the reference: PNG output without PIL,
the reflected GlobalParams, the pick readback, the kernel reload (the
reference's reload test, the CUDA library's swap, the engine's toasts) and
the capacity-growth toast."""

import ctypes
import dataclasses
import io
import os
import sys
import textwrap
import time
import types

import numpy as np
import pytest
import torch
from PIL import Image

from tinyrenderer_tpu import config as jconfig
from tinyrenderer_tpu.editor.params import describe as jdescribe
from tinyrenderer_tpu.render import global_params as jgp
from tinyrenderer_tpu.render.engine import Engine as JEngine
from tinyrenderer_tpu.utils import image_io as jimage_io
from tinyrenderer_tpu_torch import kernels
from tinyrenderer_tpu_torch.assets import mesh as meshlib
from tinyrenderer_tpu_torch.assets import native
from tinyrenderer_tpu_torch.config import RenderConfig
from tinyrenderer_tpu_torch.editor.params import describe
from tinyrenderer_tpu_torch.editor.picking import PickReadbackManager
from tinyrenderer_tpu_torch.render import global_params as tgp
from tinyrenderer_tpu_torch.render import reload as reloadlib
from tinyrenderer_tpu_torch.render.engine import Engine, RenderingAction
from tinyrenderer_tpu_torch.render.reload import KernelReloader
from tinyrenderer_tpu_torch.scene import demo
from tinyrenderer_tpu_torch.utils import image_io


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Six test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- PNG output ---------------------------------------------------------------

def _image(kind: str) -> np.ndarray:
    rng = np.random.default_rng(len(kind))
    if kind == "float":
        return rng.uniform(-0.1, 1.1, (37, 53, 3)).astype(np.float32)
    return rng.integers(0, 256, (37, 53, 4 if kind == "rgba" else 3),
                        dtype=np.uint8)


@pytest.mark.parametrize("kind", ["rgb", "rgba", "float"])
@pytest.mark.parametrize("encoder", ["native", "zlib"])
def test_png_decodes_to_the_reference_pixels(tmp_path, monkeypatch, encoder,
                                             kind):
    """The port's PNG (the native encoder, or the standard-library one when
    the native library is unavailable) decodes to the pixels of the PNG the
    reference's PIL-based save_png writes."""
    img = _image(kind)
    if encoder == "zlib":
        monkeypatch.setattr(native, "encode_png", lambda a: None)
    else:
        assert native.encode_png(np.zeros((2, 2, 3), np.uint8)) is not None
    ref_path = str(tmp_path / "ref.png")
    jimage_io.save_png(ref_path, img)
    want = np.asarray(Image.open(ref_path))
    data = image_io.encode_png(img)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))), want)
    path = str(tmp_path / "port.png")
    image_io.save_png(path, img)
    with open(path, "rb") as f:
        assert f.read() == data


def test_png_rejects_other_shapes():
    with pytest.raises(ValueError):
        image_io.encode_png(np.zeros((4, 4), np.uint8))


# -- reflected GlobalParams ---------------------------------------------------

def _spec(cls):
    return [(f.name, f.type, f.default, dict(f.metadata))
            for f in dataclasses.fields(cls)]


def test_global_params_match_the_reference():
    """The same fields, defaults and ui_param metadata, the same reflected
    tree, and to_device the reference's vector on the asked device."""
    assert _spec(tgp.GlobalParams) == _spec(jgp.GlobalParams)
    assert _spec(tgp.GlobalCPUParams) == _spec(jgp.GlobalCPUParams)
    for kw in ({}, dict(exposure=2.5, tone_mapping_type=3, ssr_thickness=0.5,
                        ssr_strength=0.75, shadow_bias=-0.004)):
        t, j = tgp.GlobalParams(**kw), jgp.GlobalParams(**kw)
        v = t.to_device("cpu")
        assert v.dtype == torch.float32 and v.device.type == "cpu"
        np.testing.assert_array_equal(v.numpy(), np.asarray(j.to_device()))
        assert describe(t, "global_params") == jdescribe(j, "global_params")


# -- pick readback ------------------------------------------------------------

def test_pick_readback_bounds_and_latest():
    """0 before the first frame and outside the frame; the element under
    the cursor inside it; latest is the newest frame's whole map, copied
    once a frame."""
    p = PickReadbackManager()
    assert p.get_object_id_at(1, 1) == 0 and p.latest is None
    pick = torch.arange(6 * 9, dtype=torch.int32).reshape(6, 9)
    p.on_end_frame(pick)
    for x, y in ((-1, 0), (0, -1), (9, 0), (0, 6), (9.5, 2), (1e9, 1e9)):
        assert p.get_object_id_at(x, y) == 0, (x, y)
    assert p.get_object_id_at(3.7, 2.2) == 2 * 9 + 3
    assert p.get_object_id_at(8.99, 5.99) == 5 * 9 + 8
    latest = p.latest
    np.testing.assert_array_equal(latest, pick.numpy())
    assert p.latest is latest                  # one copy a frame
    assert p.get_object_id_at(0, 1) == 9
    p.update()
    p.flush()
    p.on_end_frame(pick + 100)                 # the newest frame wins
    assert p.get_object_id_at(0, 0) == 100
    np.testing.assert_array_equal(p.latest, pick.numpy() + 100)


# -- kernel reload ------------------------------------------------------------

def _write_module(path, value):
    path.write_text(textwrap.dedent(f"""
        VALUE = {value}
        """))


def test_reload_picks_up_changes(tmp_path):
    """The reference's reload test on the port's KernelReloader."""
    mod_path = tmp_path / "fake_kernel_mod.py"
    _write_module(mod_path, 1)
    sys.path.insert(0, str(tmp_path))
    try:
        import fake_kernel_mod  # noqa: F401
        reloader = KernelReloader(modules=("fake_kernel_mod",))

        res = reloader.reload_if_changed()
        assert res.ok and not res.changed  # untouched -> no-op

        time.sleep(0.01)
        _write_module(mod_path, 2)
        os.utime(mod_path, (time.time() + 1, time.time() + 1))
        res = reloader.reload_if_changed()
        assert res.ok and res.reloaded == ["fake_kernel_mod"]
        assert sys.modules["fake_kernel_mod"].VALUE == 2

        # broken edit: error surfaces, old module keeps running
        mod_path.write_text("VALUE = (unclosed\n")
        os.utime(mod_path, (time.time() + 2, time.time() + 2))
        res = reloader.reload_if_changed()
        assert not res.ok and "fake_kernel_mod" in res.error
        assert sys.modules["fake_kernel_mod"].VALUE == 2

        # fixing the file reloads again (mtime was not committed on failure)
        _write_module(mod_path, 3)
        os.utime(mod_path, (time.time() + 3, time.time() + 3))
        res = reloader.reload_if_changed()
        assert res.ok and sys.modules["fake_kernel_mod"].VALUE == 3
    finally:
        sys.path.remove(str(tmp_path))
        sys.modules.pop("fake_kernel_mod", None)


class _FakeLib:
    """A loaded library: any entry point, named after its file."""

    def __init__(self, path):
        self.name = os.path.basename(path)

    def __getattr__(self, name):
        return type("Fn", (), {})()

    def __eq__(self, other):
        return isinstance(other, _FakeLib) and other.name == self.name


@pytest.fixture()
def fake_library(monkeypatch, tmp_path):
    """kernels with a 'loaded' library and a build that records its calls:
    the swap logic of kernels.reload without nvcc or a card."""
    calls, source_hash, old = [], ["a"], object()
    monkeypatch.setattr(kernels, "_lib", old)
    monkeypatch.setattr(kernels, "_lib_path", tmp_path / "libtr_kernels_a.so")
    monkeypatch.setattr(kernels, "library_path",
                        lambda: tmp_path / f"libtr_kernels_{source_hash[0]}.so")

    def build():
        calls.append("build")
        if source_hash[0] == "broken":
            raise RuntimeError("nvcc failed (2):\nraster.cu(1): error: expected a ';'")
        return kernels.library_path()
    monkeypatch.setattr(kernels, "build", build)
    monkeypatch.setattr(kernels, "ctypes", types.SimpleNamespace(
        CDLL=_FakeLib, c_int=ctypes.c_int))
    return old, calls, source_hash


def test_library_reload_swaps_only_after_a_build(fake_library):
    """Unchanged sources: nothing built, no swap. Changed sources: built,
    loaded and swapped. A failed build raises and keeps the old library;
    through KernelReloader it is an error naming the library."""
    old, calls, h = fake_library
    assert kernels.reload() is False and calls == [] and kernels._lib is old
    assert KernelReloader(modules=()).reload_if_changed(library=True).reloaded == []
    h[0] = "b"
    assert kernels.reload() is True and calls == ["build"]
    assert kernels._lib == _FakeLib("libtr_kernels_b.so")
    assert kernels._lib_path.name == "libtr_kernels_b.so"
    assert kernels.library() is kernels._lib
    h[0] = "broken"
    swapped = kernels._lib
    with pytest.raises(RuntimeError):
        kernels.reload()
    assert kernels._lib is swapped
    res = KernelReloader(modules=()).reload_if_changed(library=True)
    assert not res.ok and res.error.startswith(reloadlib.LIBRARY)
    assert "expected a ';'" in res.error and kernels._lib is swapped
    h[0] = "c"
    res = KernelReloader(modules=()).reload_if_changed(library=True)
    assert res.ok and res.reloaded == [reloadlib.LIBRARY]


def test_library_reload_without_a_loaded_library(monkeypatch):
    """Nothing loaded: nothing to swap and nothing built (the next launch
    builds from the current sources)."""
    monkeypatch.setattr(kernels, "_lib", None)
    monkeypatch.setattr(kernels, "build", lambda: pytest.fail("built"))
    assert kernels.reload() is False


def _engine():
    return Engine.from_world(demo.build_demo_world(n_cubes=4),
                             camera=demo.build_demo_camera(128, 64),
                             cfg=RenderConfig(width=128, height=64),
                             device="cpu")


def test_cpu_engine_never_runs_nvcc(fake_library):
    """A changed csrc/ hash and a build that would fail: an engine on the
    CPU reloads no library and reports its kernels up to date."""
    old, calls, h = fake_library
    h[0] = "b"
    eng = _engine()
    res = eng.recompile_kernels()
    assert res.ok and not res.changed and calls == [] and kernels._lib is old
    assert [t.message for t in eng.notifier.history()] == ["Kernels up to date"]


def test_engine_reload_toasts_and_rebakes(tmp_path):
    """A changed env module is reloaded: the packer is rebuilt, a repack
    and the environment bakes are queued, and a toast names it; a broken
    edit pushes an error toast and keeps the old module."""
    pkg = tmp_path / "fakeops"
    pkg.mkdir()
    (pkg / "__init__.py").write_text("")
    _write_module(pkg / "env.py", 1)
    sys.path.insert(0, str(tmp_path))
    try:
        import fakeops.env  # noqa: F401
        eng = _engine()
        eng._reloader = KernelReloader(modules=("fakeops.env",))
        eng.update()
        packer = eng._packer
        eng._actions.clear()
        _write_module(pkg / "env.py", 2)
        os.utime(pkg / "env.py", (time.time() + 1, time.time() + 1))
        res = eng.recompile_kernels()
        assert res.ok and res.reloaded == ["fakeops.env"]
        assert sys.modules["fakeops.env"].VALUE == 2
        assert eng._packer is not packer and eng._needs_pack
        assert eng._actions == [RenderingAction.GENERATE_CUBEMAP,
                                RenderingAction.BAKE_IRRADIANCE]
        (pkg / "env.py").write_text("VALUE = (unclosed\n")
        os.utime(pkg / "env.py", (time.time() + 2, time.time() + 2))
        res = eng.recompile_kernels()
        assert not res.ok and sys.modules["fakeops.env"].VALUE == 2
        toasts = [(t.message, t.level) for t in eng.notifier.history()]
        assert toasts[0] == ("Reloaded kernels: env", "info")
        assert toasts[1][1] == "error" and "fakeops.env" in toasts[1][0]
    finally:
        sys.path.remove(str(tmp_path))
        sys.modules.pop("fakeops.env", None)
        sys.modules.pop("fakeops", None)


# -- capacity toasts ----------------------------------------------------------

def test_capacity_growth_pushes_the_reference_warning():
    """A frame whose bins overflow grows the capacity and pushes a warning
    toast; the reference's engine, given the same monitor value, pushes
    the same toast."""
    cfg = RenderConfig(width=128, height=64, tile_h=16, bin_capacity=8,
                       shadow_size=128, shadow_tile=128, env_size=32,
                       irradiance_size=8, texture_size=64, mip_levels=4)
    eng = Engine.from_world(demo.build_demo_world(n_cubes=4,
                                                  with_point_light=False),
                            camera=demo.build_demo_camera(128, 64), cfg=cfg,
                            device="cpu")
    out = eng.run_frame()
    v = int(out.bin_overflow)
    assert v > 8 and eng.cfg.bin_capacity > 8
    toasts = [(t.message, t.level) for t in eng.notifier.history()]
    assert ("Raster bin overflow", "warning") in [
        (m.split(" (")[0], lvl) for m, lvl in toasts]
    je = JEngine(cfg=jconfig.RenderConfig(**dataclasses.asdict(cfg)))
    je._apply_monitor_values(("bins",), [v])
    te = Engine(cfg=cfg, device="cpu")
    te._apply_monitor_values(("bins",), [v])
    mine = [(t.message, t.level) for t in te.notifier.history()]
    assert mine == [(t.message, t.level) for t in je.notifier.history()]
    assert mine[0] in toasts


def test_orbit_writes_frames_and_a_gif(tmp_path, monkeypatch):
    """The port's turntable (tools/orbit.py): two settled frames of the
    demo world at 64x32 on the CPU, written as PNGs and as one looping GIF
    that PIL decodes to the frames through the encoder's 3-3-2 palette;
    its CLI refuses to render without a CUDA device unless asked for the
    CPU."""
    from tinyrenderer_tpu_torch.tools import orbit
    cfg = RenderConfig(width=64, height=32, tile_h=16, tile_w=64,
                       shadow_size=64, shadow_tile=64, env_size=16,
                       irradiance_size=8)
    eng = Engine.from_world(demo.build_demo_world(n_cubes=6),
                            camera=demo.build_demo_camera(64, 32), cfg=cfg,
                            device="cpu")
    frames = orbit.orbit(eng, 2, str(tmp_path), gif=True)
    assert eng._settled and eng.frame_index >= 2
    assert len(frames) == 2 and frames[0].shape == (32, 64, 3)
    assert not np.array_equal(frames[0], frames[1])      # the camera moved
    pal = image_io._palette_332()
    with Image.open(tmp_path / "orbit.gif") as gif:
        assert gif.n_frames == 2 and gif.info.get("loop") == 0
        for k, f in enumerate(frames):
            gif.seek(k)
            idx = ((f[..., 0] >> 5) << 5) | ((f[..., 1] >> 5) << 2) | (f[..., 2] >> 6)
            assert np.array_equal(np.asarray(gif.convert("RGB")), pal[idx])
    for k, f in enumerate(frames):
        with Image.open(tmp_path / f"frame_{k:04d}.png") as png:
            assert np.array_equal(np.asarray(png.convert("RGB")), f)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        orbit.main(["--frames", "1", "--out", str(tmp_path / "none")])
    assert "no CUDA device" in str(e.value.code)
    assert not (tmp_path / "none").exists()


def test_obj_fallback_keys_a_vertex_by_its_index_triple(tmp_path, monkeypatch):
    """Tokens that differ in text but name one (v, vt, vn) triple ("1/1/1",
    "01/1/1", "-4/-4/-1") are one vertex in the Python fallback, as in the
    native loader: both give the same mesh."""
    obj = ("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nvt 0 0\nvt 1 0\nvt 1 1\n"
           "vt 0 1\nvn 0 0 1\nf 1/1/1 2/2/1 3/3/1\nf 01/1/1 3/3/1 4/4/1\n"
           "f -4/-4/-1 03/3/01 4/4/1\n")
    path = tmp_path / "quad.obj"
    path.write_text(obj)
    assert native.available()
    nat = meshlib.load_obj(str(path))
    monkeypatch.setattr(native, "parse_obj", lambda p: None)
    py = meshlib.load_obj(str(path))
    assert py.positions.shape[0] == 4
    for f in dataclasses.fields(py):
        np.testing.assert_array_equal(getattr(py, f.name),
                                      getattr(nat, f.name), err_msg=f.name)

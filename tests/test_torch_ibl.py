"""The port's default-IBL generator (``tools/gen_default_ibl.py``) against
the JAX package's bake: the procedural sky, its cube, the irradiance
convolution, float16. Small sizes on the CPU (cube 32, irradiance 8) into
a temporary file; the full-size bake against the checked-in asset is
``slow``."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinyrenderer_tpu.assets import hdr as jhdr
from tinyrenderer_tpu.ops import env as jenv
from tinyrenderer_tpu_torch.tools import gen_default_ibl

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSET = os.path.join(ROOT, "tinyrenderer_tpu_torch", "assets",
                     "default_ibl.npz")


def _jax_bake(cube: int, size: int) -> np.ndarray:
    """The reference tool's steps (``tools/gen_default_ibl.py``)."""
    c = jenv.equirect_to_cubemap(np.asarray(jhdr.procedural_sky()), cube,
                                 gamma_decode=False)
    return np.asarray(jenv.bake_irradiance(jnp.asarray(c), size), np.float16)


def _within_one_f16_ulp(a: np.ndarray, b: np.ndarray) -> None:
    """Equal to float16 rounding: the float32 bakes sum the same samples in
    the same chunks and may differ in the last float32 bits, which moves a
    value across a float16 rounding boundary, by one float16 step."""
    assert a.dtype == b.dtype == np.float16 and a.shape == b.shape
    step = np.spacing(np.abs(b)).astype(np.float32)
    d = np.abs(a.astype(np.float32) - b.astype(np.float32))
    assert (d <= step).all(), float((d / step).max())


def test_generator_matches_the_jax_bake(tmp_path, capsys):
    out = tmp_path / "ibl.npz"
    assert gen_default_ibl.main(["--device", "cpu", "--out", str(out),
                                 "--cube", "32", "--size", "8"]) == 0
    assert "shape (6, 8, 8, 3)" in capsys.readouterr().out
    with np.load(out) as f:
        assert f.files == ["irradiance"]
        irr = f["irradiance"]
    assert irr.shape == (6, 8, 8, 3) and (irr > 0).all()
    _within_one_f16_ulp(irr, _jax_bake(32, 8))


def test_generator_defaults_to_the_ports_asset():
    """Without ``--out`` it writes the port's asset, never the JAX
    package's; without a card the default device is refused."""
    assert gen_default_ibl.DEFAULT_OUT == ASSET
    if not torch.cuda.is_available():
        assert gen_default_ibl.main([]) == 1


@pytest.mark.slow
def test_full_size_bake_matches_the_checked_in_asset():
    """The default sizes (cube 256, irradiance 64) on the CPU: within one
    float16 step of the asset."""
    with np.load(ASSET) as f:
        _within_one_f16_ulp(gen_default_ibl.bake("cpu"), f["irradiance"])

"""The hand-written CUDA kernels against their plain versions on the card
(small shapes; chip_smoke.py covers the 1080p shapes). Marked ``cuda``;
the ``cuda`` fixture skips them where no CUDA device is present. On the
card (no JAX there, so without the suite's conftest):
``python3 -m pytest tests/test_torch_cuda.py --noconftest -q``."""

import numpy as np
import pytest
import torch

from tinyrenderer_tpu_torch.ops import raster, resolve, shading


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the card)")
    return torch.device("cuda")


def _bins(dev, th, tw, seed=0):
    rng = np.random.default_rng(seed)
    T, W, H = 300, 2 * tw, 2 * th
    V = 3 * T
    w = rng.uniform(0.5, 2.0, V)
    clip = np.stack([rng.uniform(-1.2, 1.2, V) * w, rng.uniform(-1.2, 1.2, V) * w,
                     rng.uniform(0.05, 0.9, V) * w, w], 1).astype(np.float32)
    setup = raster.triangle_setup(torch.from_numpy(clip).to(dev),
                                  torch.arange(V, dtype=torch.int32, device=dev).reshape(T, 3),
                                  torch.ones(T, dtype=torch.bool, device=dev), W, H, "none")
    return setup, raster.bin_triangles_dense(setup, W, H, th, tw, 128)


@pytest.mark.cuda
@pytest.mark.parametrize("th,tw", [(16, 128), (128, 128)])
def test_raster_kernel_matches_plain(cuda, th, tw):
    _, bins = _bins(cuda, th, tw)
    n = raster.K1_LAUNCHES
    tid, z = raster.rasterize_binned(bins, th, tw)
    rid, rz = raster.rasterize_binned_ref(bins, th, tw)
    torch.cuda.synchronize()
    assert raster.K1_LAUNCHES == n + 1
    assert torch.equal(tid, rid) and torch.equal(z, rz)


@pytest.mark.cuda
@pytest.mark.parametrize("slim", [True, False])
@pytest.mark.parametrize("bf16", [True, False])
def test_select_eval_kernel_matches_plain(cuda, slim, bf16):
    setup, bins = _bins(cuda, 16, 128)
    tid, _ = raster.rasterize_binned(bins, 16, 128)
    D = resolve.ROW_D_SLIM if slim else resolve.ROW_D
    table = torch.randn(setup.rows.shape[0], D, device=cuda)
    a = resolve.select_eval(tid, table, bf16=bf16)
    b = resolve.select_eval_ref(tid, table, bf16=bf16)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
def test_shade_kernel_matches_plain(cuda):
    setup, bins = _bins(cuda, 16, 128)
    tid, _ = raster.rasterize_binned(bins, 16, 128)
    table = torch.rand(setup.rows.shape[0], resolve.ROW_D_SLIM, device=cuda)
    outf, outh = resolve.select_eval(tid, table)
    H, W = tid.shape
    lights = shading.ShadingLights(
        point_position=torch.tensor([[0.5, 4.0, -1.0]], device=cuda),
        point_color=torch.tensor([[30.0, 28.0, 25.0]], device=cuda),
        dir_direction=torch.tensor([[-0.4, -0.8, -0.3]], device=cuda),
        dir_color=torch.tensor([[2.0, 1.9, 1.7]], device=cuda),
        dir_viewproj=torch.eye(4, device=cuda)[None])
    gates = (torch.rand(2, H, W, device=cuda) > 0.3).float()
    sky = torch.rand(3, H, W, device=cuda)
    sh = torch.rand(9, 3, device=cuda)
    cam = torch.tensor([-6.0, 5.0, 1.0], device=cuda)
    a = shading.shade_deferred_fused(tid, outf, outh, gates, sky, cam, lights,
                                     1, 1, sh)
    b = shading.shade_fused_ref(tid, outf, outh, gates, sky,
                                shading.pack_shading_consts(cam, lights, 1, 1, sh),
                                1, 1, True)
    torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)

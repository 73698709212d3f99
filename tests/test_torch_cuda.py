"""The hand-written CUDA kernels (K1-K7) against their plain versions on
the card (small shapes; chip_smoke.py covers the 1080p shapes). Marked ``cuda``;
the ``cuda`` fixture skips them where no CUDA device is present. On the
card (no JAX there, so without the suite's conftest):
``python3 -m pytest tests/test_torch_cuda.py --noconftest -q``."""

import numpy as np
import pytest
import torch

from tinyrenderer_tpu_torch.ops import raster, resolve, sampling, shading


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
@pytest.mark.parametrize("th,tw,K,D", [(16, 128, 128, 53), (64, 128, 256, 53),
                                       (16, 128, 8, 7)])
def test_raster_resolve_kernel_matches_plain(cuda, th, tw, K, D):
    """K6 on dense bins (K = 8 clamps the counts; D = 7 an odd row width):
    tri_id, depth and the selected rows bit-equal to the plain version."""
    setup, _ = _bins(cuda, th, tw)
    H, W = 2 * th, 2 * tw
    bins = raster.bin_triangles_dense(setup, W, H, th, tw, K)
    table = torch.randn(setup.rows.shape[0], D, device=cuda)
    n = raster.K6_LAUNCHES
    a = raster.rasterize_resolve_binned(bins, table, th, tw)
    b = raster.rasterize_resolve_binned_ref(bins, table, th, tw)
    torch.cuda.synchronize()
    assert raster.K6_LAUNCHES == n + 1
    assert (b[0] >= 0).float().mean() > 0.2
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def _stream(dev, th, tw, Ls, cluster=False, seed=1):
    """Stream bins of 6000 small triangles (a few pixels each, as a
    high-poly mesh gives) plus a few screen-sized ones (the big list).
    ``cluster`` packs the small ones into the top right tile, whose
    segment then outgrows the walked window."""
    rng = np.random.default_rng(seed)
    T, W, H = 6000, 2 * tw, 4 * th
    c = (rng.uniform((0.2, 0.6), (0.8, 0.9), (T, 1, 2)) if cluster
         else rng.uniform(-1.1, 1.1, (T, 1, 2)))
    xy = c + rng.uniform(-0.04, 0.04, (T, 3, 2))
    xy[:8] = rng.uniform(-1.5, 1.5, (8, 3, 2))
    w = rng.uniform(0.5, 2.0, (T, 3, 1))
    z = rng.uniform(0.05, 0.9, (T, 3, 1))
    clip = np.concatenate([xy * w, z * w, w], 2).reshape(-1, 4).astype(np.float32)
    setup = raster.triangle_setup(torch.from_numpy(clip).to(dev),
                                  torch.arange(3 * T, dtype=torch.int32, device=dev).reshape(T, 3),
                                  torch.ones(T, dtype=torch.bool, device=dev), W, H, "none")
    return setup, raster.bin_triangles_stream(setup, W, H, th, tw, Ls, 16)


@pytest.mark.cuda
@pytest.mark.parametrize("th,tw,Ls,kmax,cluster", [
    (8, 128, 8192, 1024, False), (8, 128, 8192, 16, True),
    (8, 128, 4096, 1024, False), (128, 128, 16384, 4096, False)])
def test_stream_raster_kernel_matches_plain(cuda, th, tw, Ls, kmax, cluster):
    _, sb = _stream(cuda, th, tw, Ls, cluster)
    ty, tx = sb.counts.shape
    n = raster.K4_LAUNCHES
    tid, z = raster.rasterize_stream(sb, ty, tx, th, tw, kmax)
    rid, rz = raster.rasterize_stream_ref(sb, ty, tx, th, tw, kmax)
    torch.cuda.synchronize()
    assert raster.K4_LAUNCHES == n + 1
    assert (rid >= 0).float().mean() > 0.2
    assert torch.equal(tid, rid) and torch.equal(z, rz)


@pytest.mark.cuda
@pytest.mark.parametrize("slim", [True, False])
@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("kmax", [4096, 16])     # 16: winners outside the window
def test_stream_select_eval_kernel_matches_plain(cuda, slim, bf16, kmax):
    setup, sb = _stream(cuda, 8, 128, 8192, cluster=True)
    ty, tx = sb.counts.shape
    tid, _ = raster.rasterize_stream(sb, ty, tx, 8, 128, 4096)
    D = resolve.ROW_D_SLIM if slim else resolve.ROW_D
    table = torch.randn(setup.rows.shape[0], D, device=cuda)
    n = resolve.K5_LAUNCHES
    a = resolve.select_eval_stream(tid, sb, table, 8, 128, kmax, bf16=bf16)
    b = resolve.select_eval_stream_ref(tid, sb, table, 8, 128, kmax, bf16=bf16)
    torch.cuda.synchronize()
    assert resolve.K5_LAUNCHES == n + 1
    assert all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("textured", [False, True])
def test_shade_kernel_matches_plain(cuda, textured):
    """Flat (slim table) and textured (full table + material plane rec_c,
    use_tex on about half the pixels)."""
    setup, bins = _bins(cuda, 16, 128)
    tid, _ = raster.rasterize_binned(bins, 16, 128)
    D = resolve.ROW_D if textured else resolve.ROW_D_SLIM
    table = torch.rand(setup.rows.shape[0], D, device=cuda)
    if textured:
        table[:, -3] = (torch.rand(table.shape[0], device=cuda) > 0.5).float()
    outf, outh = resolve.select_eval(tid, table)
    H, W = tid.shape
    rec = torch.rand(9, H, W, device=cuda) if textured else None
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
    n = shading.K3_LAUNCHES
    a = shading.shade_deferred_fused(tid, outf, outh, rec, gates, sky, cam,
                                     lights, 1, 1, sh)
    b = shading.shade_fused_ref(tid, outf, outh, rec, gates, sky,
                                shading.pack_shading_consts(cam, lights, 1, 1, sh),
                                1, 1, True)
    torch.cuda.synchronize()
    assert shading.K3_LAUNCHES == n + 1
    torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("channel_first", [False, True])
@pytest.mark.parametrize("N", [1, 1000, 65536])
def test_windowed_blend_kernel_matches_plain(cuda, channel_first, N):
    """C = 9, indices reaching the pool's last row, fractions at 0 and
    just below 1: bit-equal to the plain version."""
    g = torch.Generator(device="cpu").manual_seed(N)
    R, C = 4000, 9
    texels = torch.randint(0, 256, (R, 4 * C), generator=g,
                           dtype=torch.uint8).to(cuda)
    idx = torch.randint(0, R, (N,), generator=g, dtype=torch.int32)
    idx[: min(N, 5)] = R - 1
    fx, fy = torch.rand(N, generator=g), torch.rand(N, generator=g)
    fx[: min(N, 3)] = 0.0
    fy[: min(N, 3)] = 1.0 - 2.0 ** -24
    idx, fx, fy = idx.to(cuda), fx.to(cuda), fy.to(cuda)
    n = sampling.K7_LAUNCHES
    a = sampling.windowed_blend(texels, idx, fx, fy, C, channel_first)
    b = sampling.windowed_blend_ref(texels, idx, fx, fy, C, channel_first)
    torch.cuda.synchronize()
    assert sampling.K7_LAUNCHES == n + 1
    assert a.shape == b.shape == ((C, N) if channel_first else (N, C))
    assert torch.equal(a, b)

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


def _same(a, b):
    """Bit-equal, -0.0 and +0.0 told apart."""
    return a.dtype == b.dtype and torch.equal(
        a.view(torch.int32) if a.dtype == torch.float32 else a,
        b.view(torch.int32) if b.dtype == torch.float32 else b)


@pytest.mark.cuda
@pytest.mark.parametrize("th,tw,K", [
    (16, 128, 300),      # K no multiple of the kernel's 256-row step
    (4, 16, 64),         # a tile smaller than the block's 8 x 32 rectangle
    (24, 80, 128),       # tile_w no multiple of 32, tile_h none of 8
    (128, 128, 600)])    # the large-tile plane order, K past two steps
def test_raster_kernel_edges_match_plain(cuda, th, tw, K):
    """Counts of 0 and of K beside ordinary ones, and dead rows (id 0)
    between live ones."""
    setup, _ = _bins(cuda, th, tw)
    T = setup.rows.shape[0]
    H, W = 2 * th, 2 * tw
    rep = raster.TriangleSetup(**{f: getattr(setup, f).repeat(
        *([3] + [1] * (getattr(setup, f).ndim - 1)))
        for f in ("rows", "valid", "bbox", "screen", "inv_w", "z_ndc")})
    rep.rows[:, 12] = torch.arange(1, 3 * T + 1, device=cuda) * rep.valid
    bins = raster.bin_triangles_dense(rep, W, H, th, tw, K)
    bins.rows[:, :, 1::3] = 0.0                  # dead rows inside the count
    bins.counts[0, 0] = 0
    assert int(bins.counts[0, 1]) == K           # a full bin
    tid, z = raster.rasterize_binned(bins, th, tw)
    rid, rz = raster.rasterize_binned_ref(bins, th, tw)
    torch.cuda.synchronize()
    assert (rid[:th, :tw] == -1).all() and (rid >= 0).float().mean() > 0.2
    assert torch.equal(tid, rid) and _same(z, rz)
    table = torch.randn(3 * T, 28, device=cuda)
    a = raster.rasterize_resolve_binned(bins, table, th, tw)
    b = raster.rasterize_resolve_binned_ref(bins, table, th, tw)
    assert all(_same(x, y) for x, y in zip(a, b))


def _tie_bins(dev):
    """One 8 x 64 tile: two rows of equal depth on the same pixels, a dead
    row between them, a row of depth exactly 0, and a row past the count."""
    def row(idf, z, x_max):
        r = torch.zeros(16)
        r[2] = r[5] = 1.0                 # edges 0 and 1: 1 everywhere
        r[6], r[8] = -1.0, x_max          # edge 2: x_max - px >= 0
        r[11], r[12] = z, idf
        return r

    rows = torch.stack([row(3.0, 0.5, 40.0), torch.zeros(16),
                        row(9.0, 0.5, 20.0), row(5.0, 0.0, 64.0),
                        row(11.0, 0.9, 64.0)]).to(dev)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    return raster.Bins(ids=torch.zeros(1, 1, 5, dtype=torch.int32, device=dev),
                       rows=rows[None, None].contiguous(),
                       counts=torch.tensor([[4]], dtype=torch.int32, device=dev),
                       overflow=zero, big_overflow=zero)


@pytest.mark.cuda
def test_raster_kernels_keep_ties_and_zero_depth(cuda):
    """Equal depths: the larger id wins; depth exactly 0 still wins on its
    id. K1, K6 and K4 (the same rows as one stream segment)."""
    bins = _tie_bins(cuda)
    want = torch.tensor([8] * 20 + [2] * 20 + [4] * 24, device=cuda)
    rid, rz = raster.rasterize_binned_ref(bins, 8, 64)
    assert torch.equal(rid, want.expand(8, 64).int())
    tid, z = raster.rasterize_binned(bins, 8, 64)
    assert torch.equal(tid, rid) and _same(z, rz)
    table = torch.randn(6, 5, device=cuda)       # ids 8 >= T: zeros
    a = raster.rasterize_resolve_binned(bins, table, 8, 64)
    assert torch.equal(a[0], rid) and _same(a[1], rz)
    assert (a[2][:, :20] == 0).all()
    assert torch.equal(a[2][:, 20:], table[rid[:, 20:].long()])
    Ls = 2048
    srows = torch.zeros(Ls, 16, device=cuda)
    srows[:4] = bins.rows[0, 0, :4]
    sb = raster.StreamBins(
        ids=torch.full((Ls,), -1, dtype=torch.int32, device=cuda), rows=srows,
        starts=torch.tensor([0, 4], dtype=torch.int32, device=cuda),
        counts=bins.counts, overflow=bins.overflow,
        stream_overflow=bins.overflow, big_overflow=bins.overflow)
    sid, sz = raster.rasterize_stream(sb, 1, 1, 8, 64, 1024)
    assert torch.equal(sid, rid) and _same(sz, rz)


def _crowded(dev, T=32000):
    """T triangles of a few pixels, all inside the last of 2 x 2 tiles of
    128 x 128 pixels."""
    rng = np.random.default_rng(5)
    c = rng.uniform((0.05, -0.95), (0.95, -0.05), (T, 1, 2))
    xy = c + rng.uniform(-0.012, 0.012, (T, 3, 2))
    w = rng.uniform(0.5, 2.0, (T, 3, 1))
    z = rng.uniform(0.05, 0.9, (T, 3, 1))
    clip = np.concatenate([xy * w, z * w, w], 2).reshape(-1, 4).astype(np.float32)
    return raster.triangle_setup(
        torch.from_numpy(clip).to(dev),
        torch.arange(3 * T, dtype=torch.int32, device=dev).reshape(T, 3),
        torch.ones(T, dtype=torch.bool, device=dev), 256, 256, "none")


@pytest.mark.cuda
def test_raster_kernels_one_crowded_tile(cuda):
    """One tile of more than 30000 rows beside empty ones (scatter bins,
    K = 32768), through K1 and K6; the same triangles as a stream
    through K4."""
    setup = _crowded(cuda)
    bins = raster.bin_triangles_scatter(setup, 256, 256, 128, 128, 32768, 64)
    counts = bins.counts.reshape(-1).tolist()
    assert counts[3] > 30000 and counts[0] == 0, counts
    rid, rz = raster.rasterize_binned_ref(bins, 128, 128, chunk=64)
    tid, z = raster.rasterize_binned(bins, 128, 128)
    assert (rid[128:, 128:] >= 0).float().mean() > 0.5
    assert torch.equal(tid, rid) and _same(z, rz)
    table = torch.randn(setup.rows.shape[0], 53, device=cuda)
    a = raster.rasterize_resolve_binned(bins, table, 128, 128)
    b = raster.rasterize_resolve_binned_ref(bins, table, 128, 128, chunk=64)
    assert all(_same(x, y) for x, y in zip(a, b))
    sb = raster.bin_triangles_stream(setup, 256, 256, 128, 128, 65536, 64)
    sid, sz = raster.rasterize_stream(sb, 2, 2, 128, 128, 32768)
    pid, pz = raster.rasterize_stream_ref(sb, 2, 2, 128, 128, 32768)
    assert (pid >= 0).float().mean() > 0.1
    assert torch.equal(sid, pid) and _same(sz, pz)


@pytest.mark.cuda
@pytest.mark.parametrize("th,tw", [(64, 128), (24, 80)])
@pytest.mark.parametrize("D", [53, 28, 7, 600])
def test_raster_resolve_kernel_row_store(cuda, th, tw, D):
    """K6's store at the published row widths, an odd one and one too wide
    for the staged store, on tiles that take the vector store and on a
    ragged one that takes the scalar store; a table shorter than the ids
    (ids >= T give zeros)."""
    setup, _ = _bins(cuda, th, tw)
    bins = raster.bin_triangles_dense(setup, 2 * tw, 2 * th, th, tw, 128)
    T = setup.rows.shape[0]
    table = torch.randn(T, D, device=cuda)
    a = raster.rasterize_resolve_binned(bins, table, th, tw)
    b = raster.rasterize_resolve_binned_ref(bins, table, th, tw)
    assert all(_same(x, y) for x, y in zip(a, b))
    short = table[: T // 2].contiguous()
    c = raster.rasterize_resolve_binned(bins, short, th, tw)
    assert torch.equal(c[0], b[0]) and _same(c[1], b[1])
    beyond = b[0] >= T // 2
    assert beyond.any() and (c[2][beyond] == 0).all()
    assert _same(c[2][~beyond], b[2][~beyond])


@pytest.mark.cuda
@pytest.mark.parametrize("th,tw", [(12, 80), (64, 128)])
def test_stream_raster_kernel_tile_shapes(cuda, th, tw):
    """K4 on a ragged tile and on a tile of several block rows."""
    _, sb = _stream(cuda, th, tw, 16384)
    ty, tx = sb.counts.shape
    tid, z = raster.rasterize_stream(sb, ty, tx, th, tw, 4096)
    rid, rz = raster.rasterize_stream_ref(sb, ty, tx, th, tw, 4096)
    assert (rid >= 0).float().mean() > 0.2
    assert torch.equal(tid, rid) and _same(z, rz)


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


def _one_tile_stream(dev, n_rows, Ls, tw=128, th=8, seed=3):
    """A stream whose only tile (th x tw pixels) holds ``n_rows`` rows of
    small triangles, the later a row the nearer it is, so that a row the
    walk cuts off would have won wherever it covers a pixel."""
    rng = np.random.default_rng(seed)
    T = n_rows
    c = rng.uniform(-0.95, 0.95, (T, 1, 2))
    xy = c + rng.uniform(-0.06, 0.06, (T, 3, 2)) * (1.0, 4.0)
    z = np.linspace(0.05, 0.9, T).reshape(T, 1, 1) * np.ones((1, 3, 1))
    clip = np.concatenate([xy, z, np.ones((T, 3, 1))], 2).reshape(-1, 4)
    setup = raster.triangle_setup(
        torch.from_numpy(clip.astype(np.float32)).to(dev),
        torch.arange(3 * T, dtype=torch.int32, device=dev).reshape(T, 3),
        torch.ones(T, dtype=torch.bool, device=dev), tw, th, "none")
    rows = torch.zeros(Ls, 16, device=dev)
    rows[:T] = setup.rows
    assert bool(setup.valid.all())
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    return raster.StreamBins(
        ids=torch.full((Ls,), -1, dtype=torch.int32, device=dev), rows=rows,
        starts=torch.tensor([0, T], dtype=torch.int32, device=dev),
        counts=torch.tensor([[T]], dtype=torch.int32, device=dev),
        overflow=zero, stream_overflow=zero, big_overflow=zero)


@pytest.mark.cuda
@pytest.mark.parametrize("n_rows,Ls,kmax", [
    (0, 2048, 1024),        # an empty stream
    (300, 2048, 1024),      # one step and a bit
    (2049, 8192, 2048),     # kmax + 1 rows, all walked (nb = 2)
    (5000, 8192, 16),       # cut at 4096 rows: the nearest 904 never race
    (8192, 8192, 8192)])    # one window of the whole stream, in parts
def test_stream_raster_kernel_one_tile(cuda, n_rows, Ls, kmax):
    """One 8 x 128 tile whose window is raced in up to 32 parts that meet in
    one slot."""
    sb = _one_tile_stream(cuda, n_rows, Ls)
    tid, z = raster.rasterize_stream(sb, 1, 1, 8, 128, kmax)
    rid, rz = raster.rasterize_stream_ref(sb, 1, 1, 8, 128, kmax)
    torch.cuda.synchronize()
    if n_rows:
        assert (rid >= 0).float().mean() > 0.2
        _, stop = raster.walked_windows(sb.starts, Ls, kmax)
        assert int(rid.max()) < int(stop[0])
    else:
        assert (rid == -1).all()
    assert torch.equal(tid, rid) and _same(z, rz)


@pytest.mark.cuda
def test_stream_raster_kernel_writes_every_pixel_of_overlapping_windows(cuda):
    """Starts that no binner gives: four of eight tiles claim the same 1000
    rows, 32 parts where the list has room for 16. The first is raced in
    parts, the others whole, and every tile equals the plain version of a
    stream in which it alone holds the rows."""
    th, tw, n_tiles, Ls, T = 8, 128, 8, 1024, 1000
    rng = np.random.default_rng(5)
    c = rng.uniform(-0.95, 0.95, (T, 1, 2))
    xy = c + rng.uniform(-0.02, 0.02, (T, 3, 2)) * (1.0, 30.0)
    z = rng.uniform(0.05, 0.9, (T, 3, 1))
    clip = np.concatenate([xy, z, np.ones((T, 3, 1))], 2).reshape(-1, 4)
    setup = raster.triangle_setup(
        torch.from_numpy(clip.astype(np.float32)).to(cuda),
        torch.arange(3 * T, dtype=torch.int32, device=cuda).reshape(T, 3),
        torch.ones(T, dtype=torch.bool, device=cuda), n_tiles * tw, th, "none")
    rows = torch.zeros(Ls, 16, device=cuda)
    rows[:T] = setup.rows
    zero = torch.zeros((), dtype=torch.int32, device=cuda)

    def bins(starts):
        return raster.StreamBins(
            ids=torch.full((Ls,), -1, dtype=torch.int32, device=cuda),
            rows=rows, starts=torch.tensor(starts, dtype=torch.int32,
                                           device=cuda),
            counts=torch.zeros((1, n_tiles), dtype=torch.int32, device=cuda),
            overflow=zero, stream_overflow=zero, big_overflow=zero)

    tid, z = raster.rasterize_stream(bins([0, T] * 4 + [0]), 1, n_tiles, th,
                                     tw, 1024)
    torch.cuda.synchronize()
    for t in range(n_tiles):
        alone = bins([0] * (t + 1) + [T if t % 2 == 0 else 0] * (n_tiles - t))
        rid, rz = raster.rasterize_stream_ref(alone, 1, n_tiles, th, tw, 1024)
        cols = slice(t * tw, (t + 1) * tw)
        assert ((rid[:, cols] >= 0).any()) == (t % 2 == 0)
        assert torch.equal(tid[:, cols], rid[:, cols])
        assert _same(z[:, cols], rz[:, cols])


@pytest.mark.cuda
@pytest.mark.parametrize("th,tw", [(8, 50), (20, 20), (5, 200), (16, 256)])
def test_stream_raster_kernel_ragged_tiles(cuda, th, tw):
    """Tile widths that 32, 8 or 4 do not divide (the scalar store), tiles
    lower than a block's eight rows, and tiles of several sub-tiles."""
    _, sb = _stream(cuda, th, tw, 16384)
    ty, tx = sb.counts.shape
    tid, z = raster.rasterize_stream(sb, ty, tx, th, tw, 4096)
    rid, rz = raster.rasterize_stream_ref(sb, ty, tx, th, tw, 4096)
    assert (rid >= 0).float().mean() > 0.2
    assert torch.equal(tid, rid) and _same(z, rz)


@pytest.mark.cuda
def test_stream_raster_kernel_highpoly(cuda, monkeypatch):
    """The settled stream of the 108k-triangle world at 1920x1080 in 8x128
    tiles: its long silhouette windows are raced in parts."""
    from tinyrenderer_tpu_torch.config import RenderConfig
    from tinyrenderer_tpu_torch.render.engine import Engine
    from tinyrenderer_tpu_torch.scene import demo
    calls = []
    inner = raster.rasterize_stream

    def spy(*args):
        calls.append(args)
        return inner(*args)
    monkeypatch.setattr(raster, "rasterize_stream", spy)
    eng = Engine.from_world(
        demo.build_highpoly_world(9), camera=demo.build_demo_camera(1920, 1080),
        device=cuda, cfg=RenderConfig(
            width=1920, height=1080, max_instances=64, max_vertices=131072,
            max_triangles=131072, bin_capacity=1024, tile_h=8))
    for _ in range(5):                       # the capacities settle in three
        eng.run_frame(0.0)
    sb, ty, tx, th, tw, kmax = calls[-1]
    start, stop = raster.walked_windows(sb.starts, sb.rows.shape[0], kmax)
    assert int((stop - start).max()) > 1024 and (th, tw) == (8, 128)
    tid, z = inner(sb, ty, tx, th, tw, kmax)
    rid, rz = raster.rasterize_stream_ref(sb, ty, tx, th, tw, kmax)
    assert len(torch.unique(rid)) > 10000
    assert torch.equal(tid, rid) and _same(z, rz)


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
@pytest.mark.parametrize("C", [9, 4, 5])       # 4, 5: no word kernel, byte loop
@pytest.mark.parametrize("N", [0, 1, 255, 257, 1000, 65536])
def test_windowed_blend_kernel_matches_plain(cuda, channel_first, C, N):
    """Indices below 0, at the pool's last row and past it (clamped),
    fractions at 0 and just below 1, tap counts around a block's and a
    warp's: bit-equal to the plain version in both layouts."""
    g = torch.Generator(device="cpu").manual_seed(N)
    R = 4000
    texels = torch.randint(0, 256, (R, 4 * C), generator=g,
                           dtype=torch.uint8).to(cuda)
    idx = torch.randint(0, R, (N,), generator=g, dtype=torch.int32)
    idx[: min(N, 5)] = R - 1
    idx[5:9] = torch.tensor([-1, -2 ** 31, R, 2 ** 31 - 1],
                            dtype=torch.int32)[: max(0, min(N, 9) - 5)]
    fx, fy = torch.rand(N, generator=g), torch.rand(N, generator=g)
    fx[: min(N, 3)] = 0.0
    fy[: min(N, 3)] = 1.0 - 2.0 ** -24
    idx, fx, fy = idx.to(cuda), fx.to(cuda), fy.to(cuda)
    n = sampling.K7_LAUNCHES
    a = sampling.windowed_blend(texels, idx, fx, fy, C, channel_first)
    b = sampling.windowed_blend_ref(texels, idx, fx, fy, C, channel_first)
    torch.cuda.synchronize()
    assert sampling.K7_LAUNCHES == n + (N > 0)
    assert a.shape == b.shape == ((C, N) if channel_first else (N, C))
    assert _same(a, b)


@pytest.mark.cuda
def test_windowed_blend_refuses_a_misaligned_pool(cuda):
    """The word kernel reads rows as 32-bit words: a pool view that starts
    off a 4-byte boundary raises, and the same bytes aligned pass."""
    R, C = 64, 9
    buf = torch.randint(0, 256, (R * 4 * C + 4,), dtype=torch.uint8).to(cuda)
    idx = torch.arange(R, dtype=torch.int32, device=cuda)
    f = torch.rand(R, device=cuda)
    view = buf[1:1 + R * 4 * C].view(R, 4 * C)
    assert view.is_contiguous() and view.data_ptr() % 4
    with pytest.raises(ValueError, match="4-byte"):
        sampling.windowed_blend(view, idx, f, f, C)
    a = sampling.windowed_blend(view.clone(), idx, f, f, C)
    assert _same(a, sampling.windowed_blend_ref(view, idx, f, f, C))


@pytest.mark.cuda
def test_irradiance_bake_on_the_card_and_cache_round_trip(cuda, tmp_path):
    """The bake of an HDR skybox's cube on the card equals the CPU bake of
    the same cube within rtol 1e-5 / atol 1e-6 (the same 3213 weighted
    samples a texel in the same chunks; the sums round differently), the
    engine's cache file holds its float16 values, and a second engine on
    the card loads them bit-equal."""
    from tinyrenderer_tpu_torch.assets import hdr
    from tinyrenderer_tpu_torch.config import RenderConfig
    from tinyrenderer_tpu_torch.render import frame
    from tinyrenderer_tpu_torch.render.engine import Engine
    sky, cache = tmp_path / "sky.hdr", tmp_path / "ibl.data"
    sky.write_bytes(hdr.encode_hdr(hdr.procedural_sky(64, 128)))
    cfg = RenderConfig(width=256, height=128, env_size=64, irradiance_size=16)

    def engine():
        return Engine(cfg, device=cuda, skybox_path=str(sky),
                      ibl_cache_path=str(cache))

    env = engine()._ensure_env()
    assert env.irradiance.is_cuda and cache.exists()
    cpu = frame.bake_irradiance(env.env_cube.cpu(), 16)
    torch.testing.assert_close(env.irradiance.cpu(), cpu, rtol=1e-5,
                               atol=1e-6)
    raw = np.fromfile(cache, np.float16).reshape(6, 16, 16, 4)
    half = env.irradiance.cpu().numpy().astype(np.float16)
    assert np.array_equal(raw[..., :3], half) and (raw[..., 3] == 1).all()
    loaded = engine()._ensure_env().irradiance
    assert loaded.is_cuda
    assert np.array_equal(loaded.cpu().numpy(), half.astype(np.float32))


@pytest.mark.cuda
def test_library_rebuild_swap_and_failed_build(cuda, tmp_path):
    """An engine on the card: unchanged sources build nothing; an edited
    copy of csrc/ is rebuilt under a new hash and swapped in, and the
    kernels launch from it with the same results; a broken copy leaves the
    error in the result and an error toast, and the old library goes on
    serving. Restoring the sources swaps the first library back."""
    import shutil

    from tinyrenderer_tpu_torch import kernels
    from tinyrenderer_tpu_torch.config import RenderConfig
    from tinyrenderer_tpu_torch.render import reload as reloadlib
    from tinyrenderer_tpu_torch.render.engine import Engine
    eng = Engine(RenderConfig(width=256, height=128), device=cuda)
    _, bins = _bins(cuda, 16, 128)
    want = raster.rasterize_binned(bins, 16, 128)
    lib0, path0 = kernels._lib, kernels._lib_path
    csrc0, build0 = kernels.CSRC, kernels.BUILD_DIR
    res = eng.recompile_kernels()
    assert res.ok and not res.changed and kernels._lib is lib0
    try:
        edited = tmp_path / "edited"
        shutil.copytree(csrc0, edited)
        with open(edited / "select_eval.cu", "a") as f:
            f.write("\n// edited\n")
        kernels.CSRC, kernels.BUILD_DIR = edited, tmp_path / "build"
        res = eng.recompile_kernels()
        assert res.ok and res.reloaded == [reloadlib.LIBRARY]
        assert kernels._lib is not lib0 and kernels._lib_path != path0
        assert eng.notifier.history()[-1].message == "Reloaded kernels: csrc"
        n = raster.K1_LAUNCHES
        got = raster.rasterize_binned(bins, 16, 128)
        assert raster.K1_LAUNCHES == n + 1
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        lib1 = kernels._lib
        broken = tmp_path / "broken"
        shutil.copytree(edited, broken)
        with open(broken / "raster.cu", "a") as f:
            f.write("\nthis is not C++\n")
        kernels.CSRC = broken
        res = eng.recompile_kernels()
        assert not res.ok and "nvcc failed" in res.error
        assert eng.notifier.history()[-1].level == "error"
        assert kernels._lib is lib1
        got = raster.rasterize_binned(bins, 16, 128)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    finally:
        kernels.CSRC, kernels.BUILD_DIR = csrc0, build0
        res = eng.recompile_kernels()
    assert res.ok and kernels._lib_path == path0


@pytest.mark.cuda
def test_cuda_fetch_on_the_card(cuda):
    """A CUDA fetch goes through pinned memory without synchronizing; its
    result is the tensor's value, also for fetches whose pinned blocks
    were handed out again after an earlier fetch was read."""
    from tinyrenderer_tpu_torch.utils import async_fetch
    vals = [torch.arange(3, dtype=torch.int32, device=cuda) + 10 * i
            for i in range(6)]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fetches = [async_fetch.submit_fetch(v) for v in vals[:3]]
        [f.done() for f in fetches]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert fetches[0]._host.is_pinned()
    for i, f in enumerate(fetches):
        assert f.result().tolist() == [10 * i, 10 * i + 1, 10 * i + 2]
        assert f.done()
    fetches = [async_fetch.submit_fetch(v) for v in vals[3:]]
    for i, f in enumerate(fetches, 3):
        assert f.result().tolist() == [10 * i, 10 * i + 1, 10 * i + 2]


@pytest.mark.cuda
def test_engine_steady_frames_do_not_synchronize(cuda):
    """A settled CUDA engine's frames (demo.lvl, its overlay, 256x128) run
    under set_sync_debug_mode('error'); the first frame settled."""
    import os
    from tinyrenderer_tpu_torch.config import RenderConfig
    from tinyrenderer_tpu_torch.render.engine import Engine
    level = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                         "levels", "demo.lvl")
    eng = Engine(cfg=RenderConfig(width=256, height=128, bin_capacity=16,
                                  env_size=32, shadow_size=256),
                 device=cuda, level_path=level)
    first = eng.run_frame(0.0)
    assert eng._settled and eng.cfg.bin_capacity > 16
    cfg = eng.cfg
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(4):
            out = eng.run_frame(0.0)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    eng.drain_monitors()
    assert not eng._overflow_inflight and eng.cfg == cfg
    assert torch.equal(first.pick_id, out.pick_id)
    assert torch.equal(first.sdr, out.sdr)


@pytest.mark.cuda
def test_entry_on_the_card_matches_the_cpu_entry(cuda):
    """``entry("cuda")`` launches K1 (main view, overlay, shadow views), K2
    and K3 and renders the CPU entry's pick ids."""
    from tinyrenderer_tpu_torch import entry
    from tinyrenderer_tpu_torch.utils import verify
    fn, args = entry.entry("cuda")
    k = (raster.K1_LAUNCHES, resolve.K2_LAUNCHES, shading.K3_LAUNCHES)
    out = fn(*args)
    torch.cuda.synchronize()
    assert raster.K1_LAUNCHES > k[0] + 1
    assert (resolve.K2_LAUNCHES, shading.K3_LAUNCHES) == (k[1] + 1, k[2] + 1)
    cfn, cargs = entry.entry("cpu")
    ref = cfn(*cargs)
    assert torch.equal(out.pick_id.cpu(), ref.pick_id)
    res = verify.edge_aware_compare(out.sdr.cpu().numpy(), ref.sdr.numpy(),
                                    pick=ref.pick_id.numpy())
    assert res["status"] == "pass", res


@pytest.mark.cuda
def test_spec_functions_on_the_card(cuda):
    """The off-path spec functions take CUDA tensors (plain torch, no
    kernel): ``select_rows_onehot`` selects the rows the CPU selects, and
    ``sample_pool_bilinear_level`` samples the CPU's values."""
    rng = np.random.default_rng(5)
    setup, bins = _bins(torch.device("cpu"), 16, 128)
    tid, _ = raster.rasterize_binned(bins, 16, 128)
    table = torch.from_numpy(rng.random((setup.rows.shape[0], 53),
                                        dtype=np.float32))
    want = resolve.select_rows_onehot(tid, bins.ids, table, 16, 128)
    got = resolve.select_rows_onehot(tid.to(cuda), bins.ids.to(cuda),
                                     table.to(cuda), 16, 128)
    assert torch.equal(got.cpu(), want)
    mips = [rng.uniform(0, 1, (2, s, s, 4)).astype(np.float32)
            for s in (16, 8)]
    pool = sampling.pack_texture_pool(mips)
    pool_d = sampling.pack_texture_pool(mips, device=cuda)
    uv = torch.from_numpy(rng.uniform(-1, 2, (8, 16, 2)).astype(np.float32))
    tex = torch.from_numpy(rng.integers(0, 2, (8, 16)).astype(np.int32))
    for level in (0, 1):
        a = sampling.sample_pool_bilinear_level(pool, tex, uv, level)
        b = sampling.sample_pool_bilinear_level(pool_d, tex.to(cuda),
                                                uv.to(cuda), level)
        torch.testing.assert_close(b.cpu(), a, rtol=0, atol=1e-6)


@pytest.mark.cuda
def test_compiled_frame_replays_equal_the_eager_frames(cuda):
    """``entry()``'s world at ``small_config()``: the first settled frame
    captures ``compiled_frame`` and ``compiled_shadow_atlas``; replays
    across an orbiting camera and a ``set_param`` equal the eager frames
    on the same arguments bit for bit (every field), launch what the eager
    frame launches, and capture nothing more."""
    import dataclasses
    from tinyrenderer_tpu_torch.entry import small_config
    from tinyrenderer_tpu_torch.render import compiled
    from tinyrenderer_tpu_torch.render import frame as framelib
    from tinyrenderer_tpu_torch.render.engine import Engine
    from tinyrenderer_tpu_torch.scene import demo
    framelib.compiled_frame.cache_clear()
    framelib.compiled_shadow_atlas.cache_clear()
    eng = Engine.from_world(demo.build_demo_world(), cfg=small_config(),
                            device=cuda)
    eng.run_frame(0.0)
    assert eng._settled
    cfg = eng.cfg
    eng._atlas = None
    for i in range(4):
        a = 2.0 * np.pi * i / 4
        eng.camera.position = np.array([12 * np.cos(a), 6.0, 12 * np.sin(a)],
                                       np.float32)
        eng.camera.look_at(np.zeros(3, np.float32))
        if i == 2:
            eng.set_param(0, 2.0)
        c0 = compiled.launch_counts()
        out = eng.run_frame(0.0)
        c1 = compiled.launch_counts()
        args = (eng._pack.scene, eng._packer.pool_for(cfg, cuda),
                eng._pack.lights,
                torch.as_tensor(eng.camera.to_raw(), device=cuda), eng.params,
                eng._ensure_env())
        if i == 0:
            atlas = framelib.render_shadow_atlas(eng._pack.scene,
                                                 eng._pack.lights, cfg)[0]
            assert torch.equal(eng._atlas, atlas)
        c2 = compiled.launch_counts()
        ref = framelib.render_frame(*args, cfg, eng._atlas)
        c3 = compiled.launch_counts()
        torch.cuda.synchronize()
        for f in dataclasses.fields(ref):
            x, y = getattr(out, f.name), getattr(ref, f.name)
            assert x.dtype == y.dtype and torch.equal(x, y), (i, f.name)
        if i > 0:
            assert ({k: c1[k] - c0[k] for k in c0}
                    == {k: c3[k] - c2[k] for k in c0}), i
    cf = framelib.compiled_frame(cfg)
    assert eng.cfg == cfg and len(cf._entries) == 1
    assert len(framelib.compiled_shadow_atlas(cfg)._entries) == 1
    entry, = cf._entries.values()
    assert torch.equal(entry.args[3].cpu(),
                       torch.from_numpy(eng.camera.to_raw()))


# ---- csrc/fp.cu: the glue's fused multiply-adds ---------------------------------
# The bar: each kernel equals its float64 plain version element for element,
# except where the host proves (in rationals, fp.exact_chain) that the
# kernel's value is the chain with every step correctly rounded, which the
# float64 form misses on about 2^-29 of inputs; fp.sqrt is bit-equal.

def _fp_operands(dev, seed=0):
    from tinyrenderer_tpu_torch.ops import fp  # noqa: F401
    g = torch.Generator().manual_seed(seed)

    def r(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=g).to(dtype).to(dev)
    m = r(257, 16)
    return {
        "contiguous": [r(1000003), r(1000003), r(1000003), r(1000003)],
        "broadcast": [r(64, 1, 33), r(48, 33, dtype=torch.float16),
                      r(64, 48, 1, dtype=torch.bfloat16),
                      torch.tensor(0.375)],
        "strided": [m[:, 4], m[:, 5], m[3, 7], m[:, 9:10].expand(257, 3)[:, 1]],
        "misaligned": [r(4097)[1:], r(4096), r(1)[0], r(4096)[::1]],
        "transposed": [r(33, 65).t(), r(65, 1), r(1, 33), r(65, 33)],
    }


def _fp_launches(fp):
    return (fp.FMA_LAUNCHES, fp.LERP_LAUNCHES, fp.PLANE_LAUNCHES,
            fp.SQRT_LAUNCHES, fp.CHAIN_LAUNCHES)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["contiguous", "broadcast", "strided",
                                  "misaligned", "transposed"])
def test_fp_kernels_match_the_float64_forms(cuda, case):
    """fp.fma, lerp, plane (both orders), sqrt and fma_chain (1-3 pairs,
    addend, tail, root) on the card: one launch each, counted once, the
    output float32 and contiguous in the broadcast shape, equal to the
    plain version but where the exact check proves the kernel right."""
    from tinyrenderer_tpu_torch.ops import fp
    a, b, c, d = _fp_operands(cuda)[case]
    f = b.abs().float().clamp(max=1.0)
    calls = [
        ("fma", 0, lambda: fp.fma(a, b, c),
         {0: a, 1: b, 6: c}, dict(n_pairs=1)),
        ("lerp", 1, lambda: fp.lerp(a, c, f),
         {0: a, 1: c, 2: f}, dict(lerp=True)),
        ("plane", 2, lambda: fp.plane(a, b, c, d, f),
         {0: b, 1: f, 2: a, 3: d, 7: c}, dict(n_pairs=2)),
        ("plane mxu", 2, lambda: fp.plane(a, b, c, d, f, mxu_order=True),
         {0: a, 1: d, 2: b, 3: f, 7: c}, dict(n_pairs=2)),
        ("sqrt", 3, lambda: fp.sqrt(a), {6: a}, dict(root=True)),
        ("chain 3", 4, lambda: fp.fma_chain([(a, b), (c, d), (b, c)], d=a),
         {0: a, 1: b, 2: c, 3: d, 4: b, 5: c, 7: a}, dict(n_pairs=3)),
        ("chain addend root", 4, lambda: fp.fma_chain(
            [(a, a), (c, c)], c=d.abs(), root=True),
         {0: a, 1: a, 2: c, 3: c, 6: d.abs()}, dict(n_pairs=2, root=True)),
    ]
    for name, k, call, slots, kw in calls:
        n0 = _fp_launches(fp)
        out = call()
        n1 = _fp_launches(fp)
        assert [y - x for x, y in zip(n0, n1)] == [int(i == k)
                                                    for i in range(5)], name
        ref = fp.launch_ref(slots, **kw)
        torch.cuda.synchronize()
        assert out.dtype == torch.float32 and out.is_contiguous(), name
        assert out.shape == ref.shape, (name, out.shape, ref.shape)
        n = fp.prove_mismatches(out, ref, slots, **kw)
        assert n <= max(8, out.numel() // 2 ** 20), (name, n)


@pytest.mark.cuda
def test_fp_sqrt_is_bit_equal_to_the_float64_root(cuda):
    """fp.sqrt (IEEE sqrtf, no fast math) equals the float64 root rounded
    to float32 bit for bit on 2^24 consecutive bit patterns from each of
    six starts: subnormals, binades, the largest finite values, infinity
    and the NaNs (a NaN's payload comes back quieted, as the float64 root
    gives it)."""
    from tinyrenderer_tpu_torch.ops import fp
    for start in (0, 0x00800000, 0x3F000000, 0x7F000000, 0x7F800000 - 2**23,
                  0x80000000 - 2**24):
        bits = torch.arange(start, start + 2 ** 24, dtype=torch.int64,
                            device=cuda).to(torch.int32)
        x = bits.view(torch.float32)
        k, r = fp.sqrt(x), fp.sqrt_ref(x)
        assert torch.equal(k.view(torch.int32), r.view(torch.int32)), \
            hex(start)
    neg = -torch.rand(1000, device=cuda) - 1e-3
    assert bool(fp.sqrt(neg).isnan().all())


@pytest.mark.cuda
def test_fp_narrow_types_follow_the_plain_rounding(cuda):
    """A leading product of two bfloat16 operands and a lerp at a bfloat16
    fraction round in bfloat16 as the plain versions do (PyTorch does that
    step first); equal to the plain versions up to proven elements."""
    from tinyrenderer_tpu_torch.ops import fp
    g = torch.Generator().manual_seed(4)
    a, b, c = (torch.randn(512, 3, generator=g).to(torch.bfloat16).to(cuda)
               for _ in range(3))
    out = fp.fma_chain([(a, b), (c, a)])
    ref = fp.fma_chain_ref([(a, b), (c, a)])
    torch.cuda.synchronize()
    # the kernel's launch: the bfloat16 product a * b as its addend
    assert fp.prove_mismatches(out, ref, {0: c, 1: a, 6: a * b},
                               n_pairs=1) <= 2
    f = torch.rand(512, 3, generator=g).to(torch.bfloat16).to(cuda)
    out, ref = fp.lerp(a, b, f), fp.lerp_ref(a, b, f)
    torch.cuda.synchronize()
    # 1 - f and b * f rounded in bfloat16 first, as the plain version does
    assert fp.prove_mismatches(out, ref, {0: a, 1: 1.0 - f, 6: b * f},
                               n_pairs=1) <= 2


@pytest.mark.cuda
def test_fp_operands_the_kernel_does_not_take_raise(cuda):
    """Float64 and integer CUDA operands, a CPU tensor with elements beside
    CUDA ones and seven unmergeable dimensions raise; a 0-dim CPU tensor
    goes by value."""
    from tinyrenderer_tpu_torch.ops import fp
    x = torch.randn(8, 4, device=cuda)
    for bad in (x.double(), x.int(), torch.ones(8, 4)):
        with pytest.raises((TypeError, ValueError)):
            fp.fma(x, bad, x)
    seven = torch.randn((2,) * 7, device=cuda)
    with pytest.raises(ValueError):
        fp.fma(seven.permute(6, 5, 4, 3, 2, 1, 0), seven, seven)
    out = fp.fma(x, torch.tensor(2.0), torch.tensor(-1.0))
    assert torch.equal(out, fp.fma_ref(x, torch.tensor(2.0),
                                       torch.tensor(-1.0)))


@pytest.mark.cuda
def test_fp_kernels_capture_into_a_graph_without_syncs(cuda):
    """A chain launched under ``set_sync_debug_mode("error")`` and captured
    into a CUDA graph: the descriptor is a kernel parameter, so the launch
    uploads nothing; replays on new inputs equal fresh launches, and a
    0-dim CPU operand is frozen at its capture value as PyTorch's own
    scalars are."""
    from tinyrenderer_tpu_torch.ops import fp
    a, b, c = (torch.randn(4096, 3, device=cuda) for _ in range(3))
    vp = torch.randn(4, 4, device=cuda)
    fp.fma_chain([(a, vp[0, 0]), (b, vp[0, 1]), (c, vp[0, 2])], d=vp[0, 3])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            out = fp.fma_chain([(a, vp[0, 0]), (b, vp[0, 1]),
                                (c, vp[0, 2])], d=vp[0, 3])
            s = fp.sqrt(out.abs())
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for _ in range(3):
        for t in (a, b, c, vp):
            t.copy_(torch.randn_like(t))
        g.replay()
        want = fp.fma_chain([(a, vp[0, 0]), (b, vp[0, 1]), (c, vp[0, 2])],
                            d=vp[0, 3])
        torch.cuda.synchronize()
        assert torch.equal(out, want) and torch.equal(s, fp.sqrt(want.abs()))

"""Engine-wide constants and capacity configuration.

The reference engine hardcodes its capacities (MAX_LIGHTS at
src/renderer.rs:9, SHADOW_SIZE at src/light_render_data.rs:12, cubemap
resolutions at src/equirectangular_to_cubemap_renderer.rs:14 and
src/diffuse_irradiance_renderer.rs:16). We keep the same defaults but make
them a dataclass: capacities become the static shape envelope of the jitted
frame function, and growing past a capacity triggers a retrace (mirroring the
reference's grow-by-reallocating behavior at src/light_render_data.rs:145).
"""

from __future__ import annotations

from dataclasses import dataclass, replace

MAX_LIGHTS = 10            # src/renderer.rs:9
SHADOW_SIZE = 1024         # src/light_render_data.rs:12
ENV_CUBEMAP_SIZE = 1024    # src/equirectangular_to_cubemap_renderer.rs:14
IRRADIANCE_MAP_SIZE = 64   # src/diffuse_irradiance_renderer.rs:16

POINT_LIGHT_FAR_PLANE = 100.0        # src/lights.rs:16
DIRECTIONAL_LIGHT_FAR_PLANE = 250.0  # src/lights.rs:17
LIGHT_NEAR_PLANE = 0.1               # src/lights.rs:18
DIRECTIONAL_LIGHT_PROJ_SIZE = 100.0  # src/lights.rs:20

POINT_LIGHT_TYPE_RAW = 1
DIRECTIONAL_LIGHT_TYPE_RAW = 2

# Default texture resolution the material pool is resampled to. The
# reference keeps native texture sizes; a TPU texture pool needs one static
# shape, so every material texture is rescaled into this pyramid.
MATERIAL_TEXTURE_SIZE = 256
MATERIAL_MIP_LEVELS = 8  # 256 ... 2 (level i has size 256 >> i; >=2)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _next_bucket(x: int, minimum: int) -> int:
    """Round up to the next power-of-two-ish bucket to bound retraces."""
    b = max(minimum, 1)
    while b < x:
        b *= 2
    return b


@dataclass(frozen=True)
class RenderConfig:
    """Static (hashable) configuration of one compiled frame function."""

    width: int = 1920
    height: int = 1080

    # Scene capacities (padded array sizes).
    max_instances: int = 64
    max_vertices: int = 4096      # flattened per-instance vertices
    max_unique_vertices: int = 4096  # unique-mesh vertex rows (instance-
    #   shared geometry pool; see scene_gpu.SceneGPU.vert_data)
    max_triangles: int = 2048     # flattened per-instance triangles
    max_materials: int = 64
    max_forward_triangles: int = 512  # gizmos/billboards (own small pool)
    num_point_lights: int = 1     # static active counts (retrace on change,
    num_directional_lights: int = 1  # mirroring light-buffer rebuilds)

    # Rasterizer tiling. Tile sizes are aligned to the VPU (8, 128) lanes.
    tile_h: int = 64
    tile_w: int = 128
    bin_capacity: int = 256       # max triangles binned per tile
    # Big-triangle list for the two-level scatter binning and the CSR
    # stream binning (triangles whose bbox spans >2x2 tiles are
    # dense-binned from this static list). Monitored + grown like
    # bin_capacity. The default is deliberately small: the stream path's
    # per-frame sort carries n_tiles * bin_big_capacity candidate keys
    # (94% of test.lvl's sort input at the old 512 default, for 29 actual
    # big triangles), so oversizing it taxes EVERY frame while growth is
    # a one-time retrace.
    bin_big_capacity: int = 64
    # CSR stream raster: per-tile bins are contiguous segments of ONE
    # tile-major sorted (tile, id) stream (raster.StreamBins) instead of
    # the dense capacity-padded (tiles, K) lists — every gather and every
    # kernel DMA scales with actual pair counts, not tiles * bin_capacity
    # (the round-2 1.3 Mtris/s wall). Applies to the main/forward-pipeline
    # visibility raster + select when use_pallas and not fused_resolve —
    # and only when the triangle pool is big enough to pay for the
    # per-frame stream sort (raster.stream_pays_off: measured 31.5 vs
    # 27.4 ms dense at 1080p on test.lvl's 2048-triangle pool; the stream
    # wins only past the dense/scatter crossover).
    stream_raster: bool = True
    # Total (tile, triangle) pair capacity of the stream (multiple of
    # 2048 — the kernel's DMA block). Monitored + grown like bin_capacity.
    stream_capacity: int = 32768

    # Shadows.
    shadow_size: int = SHADOW_SIZE
    shadow_tile: int = 128
    shadow_bin_capacity: int = 192

    # Environment.
    env_size: int = ENV_CUBEMAP_SIZE
    irradiance_size: int = IRRADIANCE_MAP_SIZE

    # Texture pool.
    texture_size: int = MATERIAL_TEXTURE_SIZE
    mip_levels: int = MATERIAL_MIP_LEVELS
    max_textures: int = 16        # unique texture images across materials

    # Feature toggles (each toggle value is a separate compiled program).
    enable_shadows: bool = True
    enable_ibl: bool = True
    # SSR is off by default: the reference ships its SSR as an effective
    # pass-through (screen_space_reflection.wgsl:135 stores source_color),
    # and the real ray march is a sequential 256-step gather loop that
    # dominates the frame when enabled.
    enable_ssr: bool = False
    use_pallas: bool = True       # Pallas raster kernel vs pure-jnp fallback
    # Forward-only pipeline (BASELINE config 1): one raster pass, N-dot-L
    # directional shading, no GBuffer/shadows/IBL/SSR. A cheap preview mode
    # the reference approximates with its forward renderer.
    forward_only: bool = False

    # Reduced-rate lookups (TPU gathers cost ~9 ns/element; these signals
    # are low-frequency). shadow_lookup_scale=s computes the binary shadow
    # gate (shading gates on shadow > 0, main.wgsl:228-237) on an
    # s-strided grid and re-evaluates boundary blocks exactly
    # (shadows.gate_refined_visibility) — boundary-exact hard shadows at
    # ~the coarse pass's gather cost. sky_scale=8 evaluates the skybox at
    # eighth res (the env map through a smooth unprojection). 1 = full
    # rate. Round-3 defaults moved 4 -> 8: measured -2.3 ms at 1080p for
    # 55.1 -> 53.1 dB vs reference_parity (the refinement keeps gates
    # boundary-exact; only sub-8px shadow features and sky detail soften).
    shadow_lookup_scale: int = 8
    sky_scale: int = 8
    # Coarse-sky upsample kernel: 'bilinear' (default) or 'cubic'
    # (Catmull-Rom; same cost class — phase-wise shifted adds). Cubic
    # measured a wash at 1080p/sky_scale=8 vs reference_parity (>1 LSB
    # 1.71 -> 1.81%, >4 LSB 0.40 -> 0.32%, 53.6 -> 54.2 dB): the sky is
    # only piecewise-linear in env-map texels (C0), so the coarse grid
    # misses texel-level detail no interpolant can recover — exact
    # full-rate evaluation (sky_scale=1 / sky_block_capacity) is the
    # fidelity lever, not the upsample kernel.
    sky_upsample: str = "bilinear"
    # Block-compacted EXACT sky: > 0 evaluates the skybox FULL-RATE but
    # only on the screen blocks that contain background pixels (sky is
    # masked out everywhere else), replacing the sky_scale coarse pass +
    # upsample. Exact where visible — removes the largest single >1-LSB
    # error source vs reference_parity (sky upsample: 1.71% -> 0.98% at
    # 1080p) for ~the background fraction of the dense full-rate cost.
    # Monitored + grown like tex_block_capacity; 0 = scaled sky path.
    sky_block_capacity: int = 0
    # Work list for the shadow gate refinement: (light, screen-block)
    # pairs on shadow edges — one batched pass shared by ALL lights, each
    # slot tagged with its light. Monitored + grown like
    # tex_block_capacity; 0 = refine every block (dense).
    shadow_block_capacity: int = 1536
    # Gate-refinement block shape (rows, cols). Full-lane (8, 32) rows win
    # on sparse-boundary scenes (test.lvl: 20.2 ms vs 22.7 at (8, 8),
    # capacity-fair interleaved); boundary-DENSE scenes want the smallest
    # (8, 8) block because refined ROW COUNT dominates (1440p 500-cube
    # stress: 70.4 vs 82.0 ms — its shadow edges tile the whole floor, so
    # each marked block's pixel count is the cost). Rows below 8 pad to
    # the (8, 128) vector registers; don't go lower.
    gate_block_h: int = 8
    gate_block_w: int = 32
    # Sample the sky from the windowed-RGBE u8 display cube (ONE gather per
    # bilinear tap vs four f32 gathers; sub-LSB after tone mapping). Off in
    # reference_parity (bit-exact f32 sampling).
    sky_rgbe: bool = True
    # Native-size texture storage: each material record keeps its own
    # dimensions and level count (src/texture.rs:98-252) instead of
    # resampling into the fixed texture_size pyramid — parity for assets
    # of ANY size, at the cost of two small table gathers per tap. The
    # quality path (reference_parity); the pyramid remains the speed path.
    native_texture_pool: bool = False
    # Material filtering: 'trilinear' (reference parity, 8 gathers),
    # 'dithered' (Bayer-dithered trilinear, 4 gathers — default),
    # 'bilinear' (nearest mip, 4 gathers).
    texture_filter: str = "dithered"
    # Statically skip the forward overlay (set by the engine when the scene
    # has no gizmos/billboards — saves a raster + resolve + texture taps).
    has_forward: bool = True
    # Statically skip the deferred material-sampling machinery (set by the
    # engine when NO material in the scene uses textures — the flat-only
    # high-poly workload): drops the per-pixel mip/uv math, the windowed
    # u8 gather and the block-compaction scatter/untile round trip
    # (~5 ms/frame of the 131k-triangle trace, round 4). The TPU analog of
    # the reference's flat-parameter pipeline variant
    # (src/shaders/gbuffer_geometry_flat_parameter.wgsl) never binding
    # texture groups at all.
    any_textured: bool = True
    # Select resolve rows inside the Pallas raster kernel (fused) vs a
    # separate per-tile one-hot matmul pass. Two-pass measured ~5% faster
    # at 1080p (the fused kernel's (D, P) VMEM carry serializes against its
    # MXU selects), so it is the default; the fused kernel remains available.
    fused_resolve: bool = False
    # Fused deferred-shading Pallas kernel (shading.shade_deferred_fused):
    # consumes the select+eval raw channel-first outputs, the compacted
    # material sample, the shadow gates and the sky in VMEM and evaluates
    # normalize + TBN + material select + the Cook-Torrance loop + SH-9
    # ambient + sky composite in ONE pass, writing only (3, H, W) HDR —
    # killing the (H, W, 15) attr relayout and the GBuffer-materialization
    # HBM round trips the trace attributed ~2 ms of layout copies to.
    # Engages when use_pallas and not fused_resolve, texture_scale == 1,
    # SSR off, shadows on; otherwise the unfused chain runs (identical
    # math). The sharded band renderer runs the same kernel per band
    # (parallel._render_band) unless the band is too short for its minimum
    # block (sharded_config falls back to unfused then).
    fused_shading: bool = True
    # bf16 select+eval output channels: the resolve kernels write the
    # precision-tolerant channels (geometric normal/tangent/bitangent —
    # normalized downstream — and the flat material params) as bfloat16,
    # cutting ~1/3 of the kernel-output + untile HBM traffic. world/uv/
    # record/object-id stay f32 (uv feeds texel addressing; record/oid are
    # exact integers). On-chip A/B: −1.5 ms at 1080p for −0.1 dB PSNR
    # (57.8 vs 57.9 dB against reference_parity) — on by default; off in
    # reference_parity.
    bf16_attrs: bool = True
    # Material sampling rate: 1 = per pixel; 2 = sample the composite
    # record on a half-res grid and bilinearly upsample (4x fewer texture
    # gathers, softens texture detail — a speed preset option).
    texture_scale: int = 1
    # Block-compacted texture sampling (ops/compact.py): material gathers
    # run only on the screen blocks that contain textured pixels, selected
    # into a static work list of this many blocks (grow-on-overflow like
    # the raster bins; 0 = always dense). Flat-material and background
    # blocks issue zero gathers — the TPU analog of the reference's
    # flat-material shader variant never issuing texture instructions.
    tex_block_capacity: int = 512
    # Windowed texel rows: each pool row carries the texel plus its +x/+y/
    # +x+y neighbors (36B u8), so a full bilinear tap is ONE gather instead
    # of four 9B gathers — measured 74 -> 59 ms at 1080p (TPU gathers pay
    # per row). Identical math/output to the 4-tap path. The stochastic
    # filter reads one texel anyway, so the performance preset turns this
    # off to gather narrow 9B rows.
    windowed_pool: bool = True
    # bf16 shadow-atlas storage: halves the windowed PCF row (16B -> 8B;
    # TPU gather rows pay per byte). The depth compare quantizes the
    # occluder depth to 8 mantissa bits — the back-face bake convention
    # already separates occluder and receiver by the object's thickness,
    # so the ~0.2% relative noise is far below the natural bias. Measured
    # ~0% on the 7-view default scene but −2 ms on config 2's 25-view
    # 420 MB atlas (gather cost grows with table size) — on by default,
    # off in reference_parity and the golden-verify configs (f32 compare
    # parity with the CPU goldens).
    shadow_bf16: bool = True
    # Morton (Z-curve) texel order inside each mip level: locally-smooth
    # uv streams (floors, walls) hit nearby pool rows in both u and v,
    # raising the gather unit's locality (sequential gathers measured ~5x
    # faster than random). Off by default pending on-chip A/B.
    morton_pool: bool = False
    # Internal render scale in percent (DLSS-style without the NN): the
    # deferred pipeline runs at pct/100 of the output resolution and the
    # HDR buffer is bilinearly upsampled before tone mapping (pick/depth
    # upsample nearest). Per-pixel gather cost scales with the internal
    # pixel count (75 -> ~0.56x taps). 100 = native.
    render_scale_pct: int = 100
    # Tile-compacted forward overlay (ops/resolve.py forward_overlay_tiles):
    # the overlay's one-hot select, plane evaluation and texture taps run
    # only on the raster tiles that bin a forward triangle. Gizmos and
    # light billboards cover a handful of tiles; dense-resolving them cost
    # ~36 ms of a 131 ms 1080p frame. 0 = process every tile (same math).
    fwd_tile_capacity: int = 16

    def performance_preset(self) -> "RenderConfig":
        """Gather-minimizing settings for speed-first rendering:
        stochastic-bilinear filtering (1 gather/tap), eighth-rate shadow
        gates (still boundary-exact via refinement), eighth-rate sky.
        texture_scale stays 1: with block compaction the strided-grid
        resize overhead exceeds what half-rate texturing saves (measured
        48 vs 41 ms at 1080p)."""
        return replace(self, texture_filter="stochastic",
                       shadow_lookup_scale=8, sky_scale=8,
                       windowed_pool=False)

    def fidelity_preset(self) -> "RenderConfig":
        """Highest-fidelity real-time config short of reference_parity:
        true trilinear filtering + exact full-rate sky (the two levers
        that carry ~all of the default's >1 LSB pixels vs parity; shadow
        gates and bf16 storage measured ZERO fidelity contribution).
        Measured r5 at 1080p test.lvl: 0.75% pixels >1 LSB / 0.05% >4 LSB
        / 59.3 dB vs reference_parity at ~40 ms/frame (default: 1.71% /
        0.40% / 53.6 dB at ~18 ms; parity itself: exact at ~242 ms)."""
        return replace(self, texture_filter="trilinear", sky_scale=1)

    def reference_parity(self) -> "RenderConfig":
        """Settings that reproduce the reference's sampling exactly:
        trilinear mip filtering (src/texture.rs:264-266 mipmap_filter:
        Linear), full-rate shadow/sky/texture lookups, and a 1024-squared
        texture pool with a full mip chain (the native-texture-size analog,
        src/texture.rs:98-252 — material textures upsample losslessly into
        the pool instead of downsampling to 256). Texel storage stays
        uint8, which IS the reference's RGBA8 format. The gather-saving
        approximations of the default config (dithered trilinear, half-rate
        shadow grid, quarter-rate sky) are all off; block compaction stays
        on because it is bit-exact."""
        return replace(self, texture_filter="trilinear",
                       shadow_lookup_scale=1, sky_scale=1, texture_scale=1,
                       texture_size=1024, mip_levels=10, sky_rgbe=False,
                       native_texture_pool=True, bf16_attrs=False,
                       shadow_bf16=False)

    @property
    def tiles_y(self) -> int:
        return _round_up(self.height, self.tile_h) // self.tile_h

    @property
    def tiles_x(self) -> int:
        return _round_up(self.width, self.tile_w) // self.tile_w

    @property
    def padded_height(self) -> int:
        return self.tiles_y * self.tile_h

    @property
    def padded_width(self) -> int:
        return self.tiles_x * self.tile_w

    @property
    def num_shadow_views(self) -> int:
        return 6 * self.num_point_lights + self.num_directional_lights

    def grown_for(self, n_instances: int, n_vertices: int, n_triangles: int,
                  n_materials: int, n_point: int, n_directional: int,
                  n_textures: int, n_forward: int = 0,
                  n_unique_vertices: int = 0) -> "RenderConfig":
        """Return a config whose capacities fit the given scene sizes."""
        return replace(
            self,
            max_instances=_next_bucket(n_instances, self.max_instances),
            max_vertices=_next_bucket(n_vertices, self.max_vertices),
            max_unique_vertices=_next_bucket(n_unique_vertices,
                                             self.max_unique_vertices),
            max_triangles=_next_bucket(n_triangles, self.max_triangles),
            max_materials=_next_bucket(n_materials, self.max_materials),
            max_textures=_next_bucket(n_textures, self.max_textures),
            max_forward_triangles=_next_bucket(n_forward,
                                               self.max_forward_triangles),
            num_point_lights=max(n_point, 0),
            num_directional_lights=max(n_directional, 0),
        )

"""Port parity: the fused shading plain version (K3's contract) against
the JAX fused shading kernel in Pallas interpret mode, on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinyrenderer_tpu.ops import shading as jshading
from tinyrenderer_tpu_torch.ops import shading as tshading

H, W = 32, 256


def _inputs(seed: int, slim: bool, bf16: bool):
    """Random resolved planes: unit-ish normals, world positions around the
    origin, flat materials in the demo scenes' ranges, 0/1 gates, a sky and ~20% background."""
    rng = np.random.default_rng(seed)
    cf, ch = (4, 9) if slim else (7, 15)
    tri_id = rng.integers(0, 50, (H, W)).astype(np.int32)
    tri_id[rng.uniform(size=(H, W)) < 0.2] = -1
    outf = rng.uniform(-3, 3, (cf, H, W)).astype(np.float32)
    outh = rng.uniform(-1, 1, (ch, H, W)).astype(np.float32)
    a0 = 3 if slim else 9
    # the demo scenes' material ranges: albedo, roughness 0.1..0.9, metalness
    outh[a0:a0 + 3] = rng.uniform(0.1, 0.9, (3, H, W))
    outh[a0 + 3] = rng.uniform(0.1, 0.9, (H, W))
    outh[a0 + 4] = rng.uniform(0.0, 0.5, (H, W))
    if bf16:   # round through bf16 once so both sides read the same values
        outh = np.array(jnp.asarray(outh).astype(jnp.bfloat16).astype(jnp.float32))
    gates = (rng.uniform(size=(2, H, W)) > 0.3).astype(np.float32)
    sky = rng.uniform(0, 2, (3, H, W)).astype(np.float32)
    lights = dict(point_position=np.array([[0.5, 4.0, -1.0]], np.float32),
                  point_color=np.array([[30.0, 28.0, 25.0]], np.float32),
                  dir_direction=np.array([[-0.4, -0.8, -0.3]], np.float32),
                  dir_color=np.array([[2.0, 1.9, 1.7]], np.float32),
                  dir_viewproj=np.eye(4, dtype=np.float32)[None])
    sh = rng.uniform(-0.3, 0.8, (9, 3)).astype(np.float32)
    cam = np.array([-6.0, 5.0, 1.0], np.float32)
    return tri_id, outf, outh, gates, sky, lights, sh, cam


@pytest.mark.parametrize("ibl", [True, False])
@pytest.mark.parametrize("sky_on", [True, False])
@pytest.mark.parametrize("slim,bf16", [(True, True), (False, False)])
def test_shade_fused_matches_pallas(ibl, sky_on, slim, bf16):
    """P = 1, D = 1; rtol = atol = 1e-5 (same formulas, the reference's XLA
    CPU build contracts some multiply-adds into FMAs)."""
    tri_id, outf, outh, gates, sky, lights, sh, cam = _inputs(7, slim, bf16)
    j = jshading.shade_deferred_fused(
        jnp.asarray(tri_id), jnp.asarray(outf),
        jnp.asarray(outh).astype(jnp.bfloat16 if bf16 else jnp.float32),
        None, jnp.asarray(gates), jnp.asarray(sky) if sky_on else None,
        jnp.asarray(cam), jshading.ShadingLights(**{k: jnp.asarray(v)
                                                    for k, v in lights.items()}),
        1, 1, jnp.asarray(sh) if ibl else None)
    t = tshading.shade_deferred_fused(
        torch.from_numpy(tri_id), torch.from_numpy(outf),
        torch.from_numpy(outh).to(torch.bfloat16 if bf16 else torch.float32),
        torch.from_numpy(gates), torch.from_numpy(sky) if sky_on else None,
        torch.from_numpy(cam),
        tshading.ShadingLights(**{k: torch.from_numpy(v)
                                  for k, v in lights.items()}),
        1, 1, torch.from_numpy(sh) if ibl else None)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5, atol=1e-5)

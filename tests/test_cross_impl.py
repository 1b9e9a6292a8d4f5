"""Converged cross-implementation fidelity gate.

The reference ships converged renders as its only fidelity artifact
(renders/*.png) but those are stale interactive captures with pre-current
sky constants (see tests/test_reference_fidelity.py), so the strongest
fidelity instrument available here is INTERNAL cross-validation at
convergence: the Pallas whole-path kernel (kernels/pallas_spheres.py)
and the XLA persistent-lanes megakernel (kernels/megakernel.py) are two
independent implementations of the same physics (ray_tracer.wgsl:398-471).
Accumulating both to convergence and gating RMSE catches divergence in the
rare stochastic branches (Russian roulette, glass TIR, specular draws) that
per-sample tests at 1-2 frames never reach.

CI runs 128 spp at 64x36 in interpret mode on CPU; chip_smoke.py runs the
same comparison at 128x72 up to 256 spp with the kernel compiled for the
card, gated flip-aware (deterministic silhouette flips counted apart from
the Monte-Carlo bulk, whose fitted bias floor must stay under 1%).
"""
import numpy as np
import jax.numpy as jnp
import pytest

from ray_tracer_2_tpu.engine.renderer import render_sample
from ray_tracer_2_tpu.kernels.pallas_spheres import (eligible,
                                                     render_spheres_pallas)
from ray_tracer_2_tpu.scene import scenes
from ray_tracer_2_tpu.scene.render_scene import instantiate_scene


def accumulate(render_one, frames):
    """Progressive average exactly as the framebuffer blend would do it
    (ray_tracer.wgsl:154-161 — equal weights for frame seeds 0..N-1)."""
    acc = None
    for f in range(frames):
        img = np.asarray(render_one(f), np.float64)
        acc = img if acc is None else acc + img
    return acc / frames


def test_cornell_converged_cross_impl(assets):
    from tests.conftest import require_asset
    require_asset(assets, "CornellBox-Original.obj")
    rs = instantiate_scene(scenes.cornell_box()).render_scene
    assert eligible(rs)
    W, H, RPP, FRAMES = 64, 36, 4, 32  # 128 spp

    def pallas_frame(f):
        img, _ = render_spheres_pallas(
            rs, jnp.int32(f), width=W, height=H, bounces=4,
            rays_per_pixel=RPP, skybox=True, interpret=True)
        return img

    def xla_frame(f):
        img, _ = render_sample(
            rs, jnp.int32(f), jnp.float32(1.0), width=W, height=H,
            bounces=4, rays_per_pixel=RPP, skybox=True, debug_mode=0,
            tile_rows=8)
        return img

    a = accumulate(pallas_frame, FRAMES)
    b = accumulate(xla_frame, FRAMES)
    rmse = float(np.sqrt(np.mean((a[..., :3] - b[..., :3]) ** 2)))
    # Same RNG streams -> samples are near-identical; residual is the rare
    # FP-flip path re-route averaged down by 1/spp. 1e-3 leaves ~10x head
    # room over measured (~1e-4) while catching any real physics divergence
    # (BASELINE.md north star: within 1% RMSE at 1024 spp).
    assert rmse < 1e-3, f"converged cross-impl RMSE {rmse}"

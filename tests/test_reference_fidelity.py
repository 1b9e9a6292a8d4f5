"""Fidelity vs the reference's own artifacts.

The reference ships three converged renders (`/root/reference/renders/`).
Direct RMSE gating against them is unsound — measured facts (see
scripts/fidelity_explore.py, round 2):

  * All three PNGs are interactive captures: `random_balls_render.png` has
    the egui debug panel baked into the top-left corner, and the camera pose
    does not match the scene constructor's (the horizon sits ~0.12H below
    where the (13,2,3)->origin camera of scene.rs:368-374 puts it — the
    user had flown the camera before pressing P).
  * The random-ball layout comes from an UNSEEDED rng (scene.rs:383-388) and
    cannot be reproduced.
  * The sky pixels decode to env-light constants that differ from the
    reference's own current shader: the ground band decodes to linear
    ~0.394 vs GROUND_COLOR = 0.35 (ray_tracer.wgsl:128), and the zenith to
    ~(0.12, 0.43, 0.81) vs SKY_ZENITH = (0.0788, 0.3648, 0.7264)
    (ray_tracer.wgsl:127). The captures predate the current shader
    constants. Whole-image RMSE vs our render of the *current* scene is
    0.33 in the sky band alone — the gap is in the checked-in artifact,
    not our physics.

So fidelity is gated the sound way: (1) our env light reproduces the
reference's CURRENT shader constants bitwise-level; (2) our full pipeline's
sky pixels lie exactly on that curve; (3) the stale-constant analysis above
is executable — if the reference renders ever match current constants this
test flips and the strict RMSE gate should be revisited. Draw-for-draw
physics parity vs the reference kernel is covered by the scalar-oracle
suites (test_render.py, test_oracle_mesh.py).
"""
import dataclasses
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest

REF_RENDERS = Path("/root/reference/renders")

WGSL_SKY_ZENITH = np.array([0.0788092, 0.36480793, 0.7264151], np.float32)
WGSL_GROUND = np.array([0.35, 0.3, 0.35], np.float32)  # ray_tracer.wgsl:128
WGSL_HORIZON = np.array([1.0, 1.0, 1.0], np.float32)


def _env(dirs):
    from ray_tracer_2_tpu.kernels.trace import environment_light
    d = np.asarray(dirs, np.float32)
    return np.asarray(environment_light(jnp.asarray(d)))[:, :3]


def test_env_light_matches_reference_shader_constants():
    """Zenith / horizon / ground of our env light == the WGSL constants
    (ray_tracer.wgsl:126-131, get_environment_light :214-221)."""
    out = _env([[0.0, 1.0, 0.0],        # straight up -> zenith (t=1)
                [1.0, 0.0, 0.0],        # horizon (t=0), g2s=1
                [0.0, -1.0, 0.0]])      # straight down -> ground
    # straight up carries the sun term: the WGSL sun axis (0.1,1,0.1) is
    # deliberately UNNORMALIZED (ray_tracer.wgsl:217), so dot((0,1,0),axis)
    # == 1.0 -> +SUN_INTENSITY on every channel. Preserved quirk.
    np.testing.assert_allclose(out[0], WGSL_SKY_ZENITH + 0.1, atol=2e-6)
    np.testing.assert_allclose(out[1], WGSL_HORIZON, atol=2e-6)
    np.testing.assert_allclose(out[2], WGSL_GROUND, atol=2e-6)
    # along the normalized sun axis the dot EXCEEDS 1 (|axis|=1.00995) and
    # ^500 explodes: the reference's sun is a ~14x HDR spike. Same here.
    sun_dir = np.array([0.1, 1.0, 0.1]) / np.linalg.norm([0.1, 1.0, 0.1])
    peak = _env([sun_dir.astype(np.float32)])[0]
    expected_sun = np.linalg.norm([0.1, 1.0, 0.1]) ** 500 * 0.1
    assert abs((peak - _env([[0.0, 1.0, 0.0]])[0]).mean()
               - (expected_sun - 0.1)) < 0.35 * expected_sun


def test_pipeline_sky_pixels_on_env_curve():
    """Full-pipeline miss pixels (top rows of random_balls) reproduce the
    env curve exactly — camera gen, orientation, accumulation and blend do
    not perturb the radiometry."""
    from ray_tracer_2_tpu.config import RenderParams
    from ray_tracer_2_tpu.engine.renderer import Renderer
    from ray_tracer_2_tpu.scene import scenes
    from ray_tracer_2_tpu.scene.render_scene import instantiate_scene

    host = instantiate_scene(scenes.random_balls())
    r = Renderer()
    p = RenderParams(width=96, height=54, bounces=2, rays_per_pixel=1,
                     skybox=True, frames=-1)
    fb = np.asarray(r.render(host.render_scene, p))
    # top rows of the raw framebuffer = bottom of the exported image is the
    # sky for this camera only after the export flip; use export orientation
    from ray_tracer_2_tpu.engine.export import framebuffer_to_srgb
    img = framebuffer_to_srgb(fb).astype(np.float32) / 255.0
    sky = img[:3, :, :3].reshape(-1, 3)  # top band: all rays miss (the
    # metal/glass sphere tops enter the frame from row 4 at this framing)

    el = np.linspace(0.0, 0.6, 2048)
    dirs = np.stack([np.sqrt(1 - el ** 2), el, np.zeros_like(el)], 1)
    curve = np.clip(_env(dirs), 0, 1) ** (1 / 2.2)
    dist = np.sqrt(((sky[:, None, :] - curve[None, :, :]) ** 2).sum(-1)).min(1)
    assert np.median(dist) < 0.01 and np.percentile(dist, 95) < 0.03
    # orientation: the sky band must be brighter blue than the bottom band
    assert img[:6, :, 2].mean() > img[-6:, :, 2].mean()


@pytest.mark.skipif(not REF_RENDERS.exists(), reason="reference not mounted")
def test_reference_render_constants_analysis():
    """Executable form of the mismatch analysis: the checked-in
    random_balls_render.png was made with OLDER sky constants than the
    reference's current shader. If this ever starts matching the current
    constants, replace this analysis with a strict RMSE gate."""
    from PIL import Image
    img = np.asarray(Image.open(REF_RENDERS / "random_balls_render.png")
                     ).astype(np.float32) / 255.0
    H, W = img.shape[:2]
    # ground band: rows just below the horizon, right half (no UI overlay)
    ground = img[int(0.14 * H):int(0.17 * H), int(0.55 * W):, :3]
    ground_lin = ground.reshape(-1, 3).mean(0) ** 2.2
    # sky zenith: top rows, right half
    zen = img[: int(0.02 * H), int(0.55 * W):, :3].reshape(-1, 3).mean(0) ** 2.2

    # both decode FAR from the current constants (stale capture)...
    assert np.abs(ground_lin - WGSL_GROUND).max() > 0.03, \
        "reference PNG now matches current GROUND_COLOR - add strict gate!"
    assert np.abs(zen - WGSL_SKY_ZENITH).max() > 0.05, \
        "reference PNG now matches current SKY_ZENITH - add strict gate!"
    # ...but the render is still the same FAMILY: blue-dominant sky
    # (b > g > r) and a neutral-purple ground band (r ~= b > g)
    assert zen[2] > zen[1] > zen[0]
    assert abs(ground_lin[0] - ground_lin[2]) < 0.03
    assert ground_lin[0] > ground_lin[1]

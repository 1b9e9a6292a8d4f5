"""Sphere-BVH knob (accel/wide.py pack_sphere_wide_rows) vs the dense
every-sphere cross.

The BVH is OFF by default (render_scene.SPHERE_BVH_MIN — measured slower
than the dense cross at bench scales before the H100 port) and NOT
bit-equal when forced on: XLA compiles the blocked (B, 8) leaf quadratic
and the dense (B, S) quadratic with different FMA/re-association, and
grazing hits (disc ~ 0) amplify the ulps into occasional path re-routes.
This pins the honest contract: identical winner on the overwhelming
majority of pixels, full agreement structurally (every sphere reachable,
correct leaf data — asserted in the sharded equivalence test)."""
import os

import numpy as np
import jax.numpy as jnp

from ray_tracer_2_tpu.engine.renderer import render_sample
from ray_tracer_2_tpu.scene import scenes
from ray_tracer_2_tpu.scene.render_scene import instantiate_scene


def test_sphere_bvh_near_equals_dense(monkeypatch):
    monkeypatch.setenv("RT2_SPHERE_BVH", "1")
    rs_bvh = instantiate_scene(scenes.random_balls()).render_scene
    assert rs_bvh.sphere_bvh_root >= 0
    monkeypatch.setenv("RT2_SPHERE_BVH", "0")
    rs_dense = instantiate_scene(scenes.random_balls()).render_scene
    assert rs_dense.sphere_bvh_root == -1

    W, H = 96, 54
    kw = dict(width=W, height=H, bounces=3, rays_per_pixel=1, skybox=True,
              debug_mode=0, tile_rows=8)
    a, segs_a = render_sample(rs_bvh, jnp.int32(0), jnp.float32(1.0), **kw)
    b, segs_b = render_sample(rs_dense, jnp.int32(0), jnp.float32(1.0), **kw)
    err = np.abs(np.asarray(a) - np.asarray(b)).max(axis=-1)
    frac = (err < 1e-5).mean()
    # observed: ~0.6% grazing-ray re-routes (32/5184 pixels at this size)
    assert frac >= 0.98, f"{frac:.2%} pixels match (max err {err.max()})"
    rel = abs(float(segs_a) - float(segs_b)) / float(segs_b)
    assert rel < 0.02


def test_default_disengaged():
    os.environ.pop("RT2_SPHERE_BVH", None)
    rs = instantiate_scene(scenes.random_balls()).render_scene
    assert rs.sphere_bvh_root == -1  # 485 < SPHERE_BVH_MIN: dense wins

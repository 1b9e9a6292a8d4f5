#!/usr/bin/env python
"""Offline converged-unbiasedness validation for NEE (too slow for CI).

Renders each scene to convergence through plain path tracing (the
reference's estimator) and through NEE, and reports mean ratio / RMSE /
per-sample variance ratio. Expected (CPU, ~20-40 min total):

  cornell  (nee_mode 1, inline occlusion):   ratio ~0.999, var 6-100x
  traversal (nee_mode 2, shadow segments):   ratio ~1.01,  var ~3x
  balls    (sphere light, cone-sampled):     ratio ~1.000, var ~1.1x
           (sphere lights use CONE sampling: the unoccluded estimator is
           exactly albedo*Le*(1-cos_max) — zero magnitude variance; the
           residual noise is indirect light, which NEE cannot touch).

Run: env JAX_PLATFORMS=cpu python scripts/validate_nee.py
"""
import dataclasses
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tests"))

from ray_tracer_2_tpu.config import RenderParams
from ray_tracer_2_tpu.engine.renderer import Renderer
from ray_tracer_2_tpu.scene import scenes
from ray_tracer_2_tpu.scene.render_scene import instantiate_scene


def acc(rs, nee, frames, rpp, bounces, W, H, skybox=False, collect=False):
    r = Renderer()
    p = RenderParams(width=W, height=H, bounces=bounces, rays_per_pixel=rpp,
                     skybox=skybox, nee=nee)
    per = []
    fb = None
    for f in range(frames):
        fb = r.render(rs, dataclasses.replace(p, frames=f))
        if collect:
            per.append(np.asarray(fb).copy())
    return np.asarray(fb), per


def sample_var(per):
    s = [per[0]] + [per[f] * (f + 1) - per[f - 1] * f
                    for f in range(1, len(per))]
    return np.stack([x[..., :3] for x in s]).var(axis=0).mean()


def compare(name, rs, bounces, plain_cfg, nee_cfg, W=48, H=36, skybox=False):
    t0 = time.time()
    plain, pp = acc(rs, False, *plain_cfg, bounces, W, H, skybox,
                    collect=True)
    nee, pn = acc(rs, True, *nee_cfg, bounces, W, H, skybox, collect=True)
    mp, mn = plain[..., :3].mean(), nee[..., :3].mean()
    rmse = float(np.sqrt(((nee - plain)[..., :3] ** 2).mean()))
    print(f"{name:10s} ratio {mn / mp:.4f}  rmse {rmse:.4f}  "
          f"var x{sample_var(pp) / sample_var(pn):.1f}  "
          f"({time.time() - t0:.0f}s)")


def main():
    from test_nee import _mini_traversal_light_scene

    compare("cornell", instantiate_scene(scenes.cornell_box()).render_scene,
            4, (512, 8), (128, 4))
    compare("balls", instantiate_scene(scenes.balls()).render_scene,
            3, (400, 4), (100, 2), W=48, H=27)
    compare("traversal", _mini_traversal_light_scene(),
            3, (192, 8), (64, 4), W=32, H=20)


if __name__ == "__main__":
    main()

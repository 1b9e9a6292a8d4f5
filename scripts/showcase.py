#!/usr/bin/env python
"""Showcase + convergence run on the accelerator: renders every built-in scene to
renders/, measures time-to-1024spp on Cornell Box (BASELINE.md secondary
metric) and a self-convergence RMSE curve."""
import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from ray_tracer_2_tpu.config import RenderParams
from ray_tracer_2_tpu.engine.export import save_png
from ray_tracer_2_tpu.engine.renderer import Renderer
from ray_tracer_2_tpu.scene import scenes
from ray_tracer_2_tpu.scene.render_scene import instantiate_scene

OUT = Path(__file__).resolve().parents[1] / "renders"


def accumulate(host, frames, width, height, bounces=5, skybox=True):
    r = Renderer()
    p = RenderParams(width=width, height=height, bounces=bounces,
                     rays_per_pixel=1, skybox=skybox)
    fb = None
    for f in range(frames):
        fb = r.render(host.render_scene, dataclasses.replace(p, frames=f))
    fb.block_until_ready()
    return r, np.asarray(fb)


def main():
    OUT.mkdir(exist_ok=True)
    spp = int(sys.argv[1]) if len(sys.argv) > 1 else 256
    results = {}

    # ---- Cornell time-to-1024spp + convergence --------------------------
    host = instantiate_scene(scenes.cornell_box())
    r = Renderer()
    p = RenderParams(width=1920, height=1080, bounces=5, rays_per_pixel=1,
                     skybox=True)
    # warm compile
    r.render(host.render_scene, p).block_until_ready()
    t0 = time.perf_counter()
    fb = None
    checkpoints = {}
    for f in range(1024):
        fb = r.render(host.render_scene, dataclasses.replace(p, frames=f))
        if f + 1 in (64, 256, 1024):
            fb.block_until_ready()
            checkpoints[f + 1] = (time.perf_counter() - t0, np.asarray(fb))
    t1024 = checkpoints[1024][0]
    ref = np.clip(checkpoints[1024][1][..., :3], 0, 1)
    results["cornell_nan_pixels"] = int(
        (~np.isfinite(checkpoints[1024][1])).any(axis=-1).sum())
    for n in (64, 256):
        e = float(np.sqrt(np.nanmean(
            (np.clip(checkpoints[n][1][..., :3], 0, 1) - ref) ** 2)))
        results[f"cornell_rmse_{n}_vs_1024"] = round(e, 5)
    results["cornell_time_to_1024spp_s"] = round(t1024, 1)
    save_png(checkpoints[1024][1], OUT / "cornell_1024spp.png")
    print(json.dumps(results), flush=True)

    # ---- showcase renders ----------------------------------------------
    from bench import dragon_scene
    jobs = [
        ("balls", scenes.balls, True),
        ("random_balls", scenes.random_balls, True),
        ("room", scenes.room, True),
        ("room2", scenes.room_2, True),
        ("metal", scenes.metal, True),
        ("sponza", scenes.sponza, True),
        ("dragon", dragon_scene, True),
    ]
    for name, build, skybox in jobs:
        t0 = time.perf_counter()
        host = build() if name == "dragon" else instantiate_scene(build())
        _, fb = accumulate(host, spp, 960, 540, skybox=skybox)
        save_png(fb, OUT / f"{name}_{spp}spp.png")
        print(f"{name}: {spp}spp 960x540 in {time.perf_counter()-t0:.0f}s",
              flush=True)


if __name__ == "__main__":
    main()

#!/usr/bin/env python
"""Time the whole-path small-scene kernel against the XLA megakernel.

For each scene and rays-per-pixel setting, both implementations render
the same 1080p frames (5 bounces) in one process, interleaved kernel / XLA
frame by frame after a warm-up; the median frame time of each decides
where Renderer routes (engine/renderer.py, RT2_PALLAS_SPHERE_CAP). Prints
one JSON line per (scene, rpp) with both medians, the card and its power
limit.

    python scripts/ab_spheres.py [--frames 8] [--scenes metal,balls,...]
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenes", default="metal,balls,room,random_balls")
    ap.add_argument("--rpp", default="1,32")
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--bounces", type=int, default=5)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from ray_tracer_2_tpu.engine.renderer import render_sample
    from ray_tracer_2_tpu.scene import scenes
    from ray_tracer_2_tpu.scene.render_scene import instantiate_scene
    from ray_tracer_2_tpu.utils.compile_cache import enable_compile_cache
    from ray_tracer_2_tpu.utils.device import (card_name_and_power,
                                               require_gpu)

    info = require_gpu("ab_spheres.py")
    enable_compile_cache()
    card = card_name_and_power()
    for name in args.scenes.split(","):
        rs = instantiate_scene(getattr(scenes, name)()).render_scene
        for rpp in (int(r) for r in args.rpp.split(",")):
            fns = {k: jax.jit(lambda s, f, k=k: render_sample(
                s, f, jnp.float32(1.0), width=args.width,
                height=args.height, bounces=args.bounces,
                rays_per_pixel=rpp, skybox=True, debug_mode=0, tile_rows=64,
                pallas_spheres=k)) for k in (True, False)}
            segs, compile_s = {}, {}
            for k, fn in fns.items():
                t0 = time.perf_counter()
                segs[k] = float(jax.block_until_ready(
                    fn(rs, jnp.int32(0)))[1])
                compile_s[k] = time.perf_counter() - t0
            times = {True: [], False: []}
            for f in range(1, args.frames + 1):
                for k, fn in fns.items():
                    t0 = time.perf_counter()
                    jax.block_until_ready(fn(rs, jnp.int32(f)))
                    times[k].append(time.perf_counter() - t0)
            med = {k: statistics.median(v) * 1e3 for k, v in times.items()}
            print(json.dumps({
                "scene": name, "rpp": rpp,
                "resolution": f"{args.width}x{args.height}",
                "bounces": args.bounces, "frames": args.frames,
                "kernel_ms": med[True], "xla_ms": med[False],
                "kernel_over_xla": med[True] / med[False],
                "segments_kernel": segs[True], "segments_xla": segs[False],
                "first_call_s": {"kernel": compile_s[True],
                                 "xla": compile_s[False]},
                "device": info, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

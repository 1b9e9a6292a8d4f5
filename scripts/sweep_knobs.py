#!/usr/bin/env python
"""Sweep the megakernel's scheduling knobs (lanes x unroll) on the card.

Knobs are image-invariant (pixel values derive from pixel ids), so only
speed is measured: per config, one warm-up frame (compile included) and
``--frames`` timed frames through Renderer(mesh=None). Prints one JSON line
per config in the format scripts/apply_tuning.py reads
(``{"scene", "env", "kw", "mrays"}``; ``kw`` null = the current defaults).

    python scripts/sweep_knobs.py --scene sponza --lanes 16384,32768 \
        --unroll 3,5 > sweep.log
    python scripts/apply_tuning.py sweep.log --scene sponza
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default="sponza")
    ap.add_argument("--lanes", default="8192,16384,32768,65536")
    ap.add_argument("--unroll", default="3,5")
    ap.add_argument("--rpp", type=int, default=1)
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--bounces", type=int, default=5)
    args = ap.parse_args()

    import jax

    from ray_tracer_2_tpu.config import RenderParams
    from ray_tracer_2_tpu.engine.renderer import Renderer
    from ray_tracer_2_tpu.scene import scenes
    from ray_tracer_2_tpu.scene.render_scene import instantiate_scene
    from ray_tracer_2_tpu.utils.compile_cache import enable_compile_cache
    from ray_tracer_2_tpu.utils.device import (card_name_and_power,
                                               require_gpu)

    info = require_gpu("sweep_knobs.py")
    enable_compile_cache()
    card = card_name_and_power()
    rs = instantiate_scene(getattr(scenes, args.scene)()).render_scene
    p = RenderParams(width=args.width, height=args.height,
                     bounces=args.bounces, rays_per_pixel=args.rpp)
    configs = [None] + [{"lanes": int(l), "unroll": int(u)}
                        for l in args.lanes.split(",")
                        for u in args.unroll.split(",")]
    for kw in configs:
        r = Renderer(mesh=None, **(kw or {}))
        t0 = time.perf_counter()
        jax.block_until_ready(r.render(rs, p))
        first = time.perf_counter() - t0
        segs = []
        t0 = time.perf_counter()
        for f in range(1, args.frames + 1):
            r.render(rs, dataclasses.replace(p, frames=f))
            segs.append(r.last_segments)   # device scalar: no sync here
        jax.block_until_ready(r.framebuffer)
        dt = time.perf_counter() - t0
        segs = sum(float(s) for s in segs)
        print(json.dumps({"scene": args.scene, "env": {}, "kw": kw,
                          "mrays": segs / dt / 1e6,
                          "ms_per_frame": dt / args.frames * 1e3,
                          "first_frame_s": first, "rpp": args.rpp,
                          "device": info, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

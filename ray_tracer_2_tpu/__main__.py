"""Headless offline renderer: ``python -m ray_tracer_2_tpu``.

The reference can only export a converged render interactively (KeyP inside
the winit loop, app.rs:211-226 → save_render_to_file app.rs:341-465, with a
hardcoded output path). This makes the same flow a first-class batch
command: pick a scene, accumulate N samples per pixel progressively
(1 frame = 1 spp, the accumulation protocol of ray_tracer.wgsl:154-161),
write a gamma-encoded PNG, and optionally checkpoint/resume the
accumulation state (engine/checkpoint.py — bit-exact resume because the
RNG is a pure counter hash keyed by (pixel, frame)).

Examples:
    python -m ray_tracer_2_tpu --scene cornell --spp 256 -o cornell.png
    python -m ray_tracer_2_tpu --scene sponza --spp 1024 \
        --checkpoint sponza.ckpt.npz --checkpoint-every 128 --resume
"""
from __future__ import annotations

import argparse
import logging
import sys
import time
from pathlib import Path

log = logging.getLogger("ray_tracer_2_tpu.render")


def _builders():
    from ray_tracer_2_tpu.scene import scenes
    return {
        "balls": scenes.balls,
        "random_balls": scenes.random_balls,
        "room": scenes.room,
        "room2": scenes.room_2,
        "metal": scenes.metal,
        "sponza": scenes.sponza,
        "cornell": scenes.cornell_box,
        "texture_test": scenes.texture_test,
        "obj_test": scenes.obj_test,
        "bugatti": scenes.bugatti,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m ray_tracer_2_tpu",
        description="Offline progressive path-trace render to PNG.")
    ap.add_argument("--scene", default="cornell",
                    help="built-in scene name (default: cornell); one of: "
                         "balls random_balls room room2 metal sponza cornell "
                         "texture_test obj_test bugatti")
    ap.add_argument("--spp", type=int, default=256,
                    help="samples per pixel to accumulate (default 256)")
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--bounces", type=int, default=5)
    ap.add_argument("--rpp", type=int, default=1,
                    help="rays per pixel per frame (intra-frame samples)")
    ap.add_argument("--no-skybox", action="store_true")
    ap.add_argument("--normal-maps", action="store_true",
                    help="enable normal-map shading in the lit path "
                         "(the reference stubs this, ray_tracer.wgsl:440-447)")
    ap.add_argument("--antialias", action="store_true",
                    help="sub-pixel box-filter jitter per sample (the "
                         "reference never jitters the pixel grid)")
    ap.add_argument("--nee", action="store_true",
                    help="next-event estimation: explicit light sampling "
                         "at diffuse bounces (no-traversal scenes; "
                         "order-of-magnitude variance cut on Cornell-class "
                         "enclosed lights)")
    ap.add_argument("--debug-mode", type=int, default=0, choices=range(8),
                    help="0 lit, 1-7 debug channels (ray_tracer.wgsl:502-573)")
    ap.add_argument("-o", "--output", default="render.png")
    ap.add_argument("--checkpoint", default=None,
                    help="accumulation checkpoint path (.npz)")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="save the checkpoint every K frames (0 = only at "
                         "the end, if --checkpoint is set)")
    ap.add_argument("--resume", action="store_true",
                    help="resume from --checkpoint if it exists")
    ap.add_argument("--log-every", type=int, default=32)
    ap.add_argument("--batch", type=int, default=1,
                    help="frames per device dispatch (Renderer.render_batch;"
                         " bit-identical to --batch 1, but sustained "
                         "rendering pays the dispatch gap once per batch)")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO, format="%(message)s")

    builders = _builders()
    if args.scene not in builders:
        ap.error(f"unknown scene {args.scene!r}; choose from "
                 f"{' '.join(sorted(builders))}")

    import dataclasses

    import numpy as np

    from ray_tracer_2_tpu.config import DebugMode, RenderParams
    from ray_tracer_2_tpu.engine.checkpoint import (load_checkpoint,
                                                    save_checkpoint)
    from ray_tracer_2_tpu.engine.export import save_png
    from ray_tracer_2_tpu.engine.renderer import Renderer
    from ray_tracer_2_tpu.scene.render_scene import instantiate_scene

    params = RenderParams(
        width=args.width, height=args.height, bounces=args.bounces,
        rays_per_pixel=args.rpp, skybox=not args.no_skybox, frames=0,
        debug_mode=DebugMode(args.debug_mode),
        normal_maps=args.normal_maps, antialias=args.antialias,
        nee=args.nee)

    t0 = time.perf_counter()
    host = instantiate_scene(builders[args.scene]())
    log.info("scene %s instantiated in %.1f s (%d spheres, %d tris)",
             args.scene, time.perf_counter() - t0,
             host.render_scene.n_spheres,
             int(host.render_scene.n_triangles))

    renderer = Renderer()
    start_frame = 0
    ckpt = Path(args.checkpoint) if args.checkpoint else None
    if args.resume and ckpt is not None and ckpt.exists():
        import jax.numpy as jnp
        state = load_checkpoint(ckpt)
        rp = state["params"]
        if (rp.width, rp.height) != (args.width, args.height):
            log.error("checkpoint resolution %dx%d != requested %dx%d",
                      rp.width, rp.height, args.width, args.height)
            return 2
        if state["scene_name"] not in (None, args.scene):
            log.error("checkpoint is for scene %r, requested %r",
                      state["scene_name"], args.scene)
            return 2
        # the accumulation blends every frame with 1/(f+1) weights — mixing
        # estimators (different bounces/physics flags) would silently
        # average two different images
        for f in ("bounces", "rays_per_pixel", "skybox", "nee", "antialias",
                  "normal_maps", "debug_mode"):
            if getattr(rp, f) != getattr(params, f):
                log.error("checkpoint %s=%r != requested %r — refusing to "
                          "mix estimators in one accumulation", f,
                          getattr(rp, f), getattr(params, f))
                return 2
        renderer.ensure_framebuffer(rp.width, rp.height)
        renderer.framebuffer = jnp.asarray(state["framebuffer"])
        start_frame = rp.frames + 1
        log.info("resumed %s at frame %d from %s", args.scene, start_frame,
                 ckpt)

    if start_frame >= args.spp:
        log.info("checkpoint already has %d >= %d spp; writing PNG only",
                 start_frame, args.spp)

    def _save_ckpt(frame: int) -> None:
        save_checkpoint(ckpt, renderer.read_framebuffer(),
                        dataclasses.replace(params, frames=frame),
                        scene_name=args.scene, camera=host.camera)
        log.info("checkpoint @ frame %d -> %s", frame, ckpt)

    pixels = args.width * args.height
    t0 = time.perf_counter()
    fb = renderer.framebuffer
    last_frame = start_frame - 1
    batch = max(args.batch, 1)
    f = start_frame
    while f < args.spp:
        k = min(batch, args.spp - f)
        if k > 1:
            fb = renderer.render_batch(
                host.render_scene, dataclasses.replace(params, frames=f), k)
        else:
            fb = renderer.render(host.render_scene,
                                 dataclasses.replace(params, frames=f))
        f += k
        last_frame = f - 1
        done = f - start_frame
        crossed = args.log_every and (
            (done // args.log_every) > (done - k) // args.log_every)
        if args.log_every and (crossed or f == args.spp):
            fb.block_until_ready()
            dt = time.perf_counter() - t0
            segs = (np.asarray(renderer.last_segments)
                    if renderer.last_segments is not None else None)
            rate = f"{float(segs) * (done / k) / dt / 1e6:.1f} Mrays/s" \
                if segs is not None and segs.size == 1 else ""
            log.info("frame %d/%d  %.1f s  %.2f s/frame  %s",
                     f, args.spp, dt, dt / done, rate)
        if (ckpt is not None and args.checkpoint_every
                and done % args.checkpoint_every == 0
                and f != args.spp):
            _save_ckpt(last_frame)

    if fb is None:
        log.error("nothing rendered and no checkpoint framebuffer")
        return 2
    if ckpt is not None and last_frame >= start_frame:
        _save_ckpt(last_frame)
    save_png(renderer.read_framebuffer(), args.output)
    log.info("wrote %s (%d spp, %dx%d)", args.output,
             max(last_frame + 1, start_frame), args.width, args.height)
    return 0


if __name__ == "__main__":
    from ray_tracer_2_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    sys.exit(main())

#!/usr/bin/env python
"""Path-tracing throughput at 1080p on one GPU.

Prints ONE JSON line: {"metric", "value", "unit", ...} plus the device it
ran on (JAX platform, device kind and count, and the card's name and power
limit). Rays are counted exactly (traced path segments, not
width*height*spp estimates). Renders on one device unless ``--mesh`` is
given, and refuses a non-GPU backend unless ``JAX_PLATFORMS=cpu`` was set
explicitly (tests and tiny rehearsals).

Dragon_80K.obj is absent from the reference mount; the scene uses the
midpoint-subdivided dragon.obj substitute (identical surface, 80k triangles —
see ray_tracer_2_tpu/assets/procedural.py).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import threading
import time


def _hang_guard(seconds: float, stage: str, metric: str) -> threading.Event:
    """Arm a watchdog: if ``stage`` (device discovery, the first compile)
    hasn't signalled ``done`` within ``seconds``, print an explicit error
    JSON line and exit(2) instead of hanging the caller forever."""
    done = threading.Event()

    def fire():
        if not done.wait(seconds):
            print(json.dumps({
                "metric": metric, "value": 0.0, "unit": "Mrays/s/chip",
                "error": f"{stage} exceeded {seconds:.0f}s"}), flush=True)
            os._exit(2)

    threading.Thread(target=fire, daemon=True).start()
    return done


def dragon_scene():
    """Dragon_80K, single material, camera framing the model
    (BASELINE.md)."""
    import numpy as np
    from ray_tracer_2_tpu.math.transform import Transform, quat_rotate_y
    from ray_tracer_2_tpu.scene.camera import CameraDescriptor
    from ray_tracer_2_tpu.scene.definition import MeshFromFile, SceneDefinition
    from ray_tracer_2_tpu.scene.material import MaterialDefinition
    from ray_tracer_2_tpu.scene.render_scene import instantiate_scene

    s = SceneDefinition()
    s.set_camera(CameraDescriptor(
        transform=Transform.cam([0.0, 1.0, 4.0], [0.0, 0.7, 0.0]),
        fov=40.0, focus_dist=4.0))
    s.add_mesh(Transform(pos=[0.0, 0.6, 0.0], rot=quat_rotate_y(-1.5708),
                         scale=[3.0, 3.0, 3.0]),
               MeshFromFile("Dragon_80K.obj", use_mtl=False),
               MaterialDefinition.new()
               .with_color([0.96078, 0.11372, 0.4039, 1.0])
               .smooth(0.8).specular_([1.0] * 4, 0.015))
    s.add_sphere([0.0, -1000.0, 0.0], 1000.0,
                 MaterialDefinition.new().with_color([0.5, 0.5, 0.5, 1.0]))
    return instantiate_scene(s)


def named_scene(name: str):
    from ray_tracer_2_tpu.scene import scenes
    from ray_tracer_2_tpu.scene.render_scene import instantiate_scene

    if name == "dragon":
        return dragon_scene()
    builders = dict(cornell=scenes.cornell_box, sponza=scenes.sponza,
                    random_balls=scenes.random_balls, room2=scenes.room_2,
                    metal=scenes.metal, room=scenes.room, balls=scenes.balls)
    return instantiate_scene(builders[name]())


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default="dragon",
                    choices=["dragon", "cornell", "sponza", "random_balls",
                             "room2", "metal", "room", "balls"])
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--bounces", type=int, default=5)
    ap.add_argument("--rpp", type=int, default=None,
                    help="intra-frame rays per pixel (spp = frames x rpp — "
                         "the reference's progressive protocol, "
                         "egui.rs:107-113 allows up to 100). Default: 32 "
                         "for the dragon and --cornell1024, else 1")
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--frames", type=int, default=8)
    # real megakernel knobs (persistent-lanes path — the lit-render path)
    ap.add_argument("--lanes", type=int, default=None,
                    help="persistent lane count (kernels/megakernel.py)")
    ap.add_argument("--unroll", type=int, default=None,
                    help="traversal steps fused per loop iteration")
    ap.add_argument("--shade-every", type=int, default=None,
                    help="boundary/shading phase cadence in iterations")
    ap.add_argument("--claim", default=None, choices=["queue", "striped"],
                    help="pixel-assignment scheme (kernels/megakernel.py)")
    ap.add_argument("--cohorts", type=int, default=None,
                    help="independent lane sub-batches whose traversal "
                         "steps interleave (kernels/megakernel.py)")
    ap.add_argument("--boundaries", type=int, default=None,
                    help="boundary phases chained per loop iteration "
                         "(kernels/megakernel.py)")
    ap.add_argument("--packet", type=int, default=None,
                    help="rays per traversal lane (packet=P union "
                         "traversal; default 1 / tuned.json)")
    ap.add_argument("--log-cap", type=int, default=None,
                    help="completion-log append width cap per boundary")
    ap.add_argument("--mesh", type=int, default=0,
                    help="render row-sharded over an N-device mesh "
                         "(N > available devices is clamped; 0 = unsharded)")
    ap.add_argument("--mesh-spp", type=int, default=1,
                    help="with --mesh N: split the mesh into a 2-D "
                         "(N//S rows) x (S spp) hybrid — rows carry no "
                         "collectives, spp carries one pmean per frame")
    ap.add_argument("--cornell1024", action="store_true",
                    help="secondary metric (BASELINE.md): wall-clock seconds "
                         "to accumulate 1024 spp of CornellBox at the given "
                         "resolution (default 1080p); honours --rpp (spp = "
                         "frames x rpp) and --nee")
    ap.add_argument("--batch", type=int, default=16,
                    help="with --cornell1024: frames per device dispatch "
                         "(render_frames_batched; 1 = dispatch per frame)")
    ap.add_argument("--nee", action="store_true",
                    help="with --cornell1024: enable next-event estimation "
                         "(reference-divergent estimator, ~10x less variance "
                         "at equal spp — see docs/ARCHITECTURE.md)")
    ap.add_argument("--tex-budget-mb", type=int, default=None,
                    help="texel-atlas mip-0 downsampling budget in MB "
                         "(render_scene._tex_budget). 0 = exact full-res "
                         "sampling (reference parity). Default: 32 for "
                         "sponza (chosen before the H100 port; queued for "
                         "an H100 A/B), 0 elsewhere; always disclosed in the "
                         "output JSON")
    args = ap.parse_args()

    if args.rpp is None:
        args.rpp = 32 if args.cornell1024 or args.scene == "dragon" else 1
    if args.tex_budget_mb is None:
        args.tex_budget_mb = 32 if args.scene == "sponza" else 0
    if args.tex_budget_mb and "RT2_TEX_BUDGET_MB" not in os.environ:
        os.environ["RT2_TEX_BUDGET_MB"] = str(args.tex_budget_mb)

    metric = (f"{args.scene}_1080p_path_throughput"
              if args.scene != "dragon" else
              "dragon80k_1080p_path_throughput")

    guard = _hang_guard(900, "device discovery", metric)
    import jax

    from ray_tracer_2_tpu.utils.compile_cache import enable_compile_cache
    from ray_tracer_2_tpu.utils.device import (card_name_and_power,
                                               require_gpu)
    device = require_gpu("bench.py", allow_explicit_cpu=True)
    device["card"] = card_name_and_power()
    guard.set()
    enable_compile_cache()

    if args.cornell1024:
        args.device = device
        return cornell1024(args)

    from ray_tracer_2_tpu.config import RenderParams
    from ray_tracer_2_tpu.engine.renderer import Renderer

    host = named_scene(args.scene)
    p = RenderParams(width=args.width, height=args.height,
                     bounces=args.bounces, rays_per_pixel=args.rpp,
                     skybox=True, frames=0)

    if args.mesh:
        n_chips, mrays = bench_sharded(host, p, args)
    else:
        n_chips = 1
        renderer = Renderer(lanes=args.lanes, unroll=args.unroll,
                            packet=args.packet,
                            shade_every=args.shade_every, claim=args.claim,
                            cohorts=args.cohorts, boundaries=args.boundaries,
                            log_cap=args.log_cap, mesh=None)
        guard = _hang_guard(2400, "first compile/warmup", metric)
        for f in range(args.warmup):
            fb = renderer.render(host.render_scene,
                                 dataclasses.replace(p, frames=f))
        fb.block_until_ready()
        guard.set()

        t0 = time.perf_counter()
        seg_counts = []
        for f in range(args.warmup, args.warmup + args.frames):
            renderer.render(host.render_scene,
                            dataclasses.replace(p, frames=f))
            # keep the DEVICE scalar; float() here would sync every frame
            # and serialize the dispatch pipeline
            seg_counts.append(renderer.last_segments)
        renderer.framebuffer.block_until_ready()
        dt = time.perf_counter() - t0
        total_rays = sum(float(s) for s in seg_counts)
        mrays = total_rays / dt / 1e6

    out = {
        "metric": metric,
        "value": round(mrays / n_chips, 3),
        "unit": "Mrays/s/chip",
        # spp = frames x rpp is the reference's own progressive protocol
        # (egui.rs:107-113)
        "rpp": args.rpp,
        "chips": n_chips,
        "device": device,
    }
    if args.tex_budget_mb:
        out["tex_budget_mb"] = args.tex_budget_mb
        out["tex_fidelity"] = ("atlas mip-0 downsampled to the budget; "
                               "RT2_TEX_BUDGET_MB=0 / --tex-budget-mb 0 "
                               "restores exact full-res sampling")
    from ray_tracer_2_tpu import tuning
    # profile-aware disclosure: mirror megakernel.render_persistent's
    # scene-class profile pick so the reported knobs are the ones the
    # kernel actually resolved
    prof = "bigtex" if host.render_scene.tex_texels.shape[0] >= 65536 \
        else None
    resolved = dict(tuning.tuned_defaults())
    if prof is not None:
        resolved.update(
            tuning.tuned_defaults(f"{jax.default_backend()}:{prof}"))
        out["tuning_profile"] = prof
    tuned = {k: v for k, v in resolved.items()
             if getattr(args, k, None) is None}   # explicit flags override
    if tuned:
        out["tuned"] = tuned   # measured-on-chip defaults in effect

    # Geometry provenance: the reference mount omits large blobs
    # (.MISSING_LARGE_BLOBS); these scenes run on engineered substitutes.
    if args.scene == "dragon":
        out["geometry"] = ("substitute: dragon.obj midpoint-subdivided to "
                           "80k tris (identical surface; equivalence "
                           "evidence: BASELINE.md table — 0.97x fetches/ray"
                           ", 9x node table, 1.25x leaf depth)")
    elif args.scene == "sponza":
        out["geometry"] = ("substitute: procedural atrium with the real "
                           "sponza.mtl materials/textures (sponza.obj absent"
                           " from reference mount)")
    elif args.scene == "room2":
        out["geometry"] = ("substitute: Dragon_80K instances built from "
                           "dragon.obj midpoint subdivision")
    print(json.dumps(out))


def cornell1024(args):
    """Secondary metric (BASELINE.md): seconds of device time to accumulate
    1024 samples/pixel of CornellBox. spp = frames x rays_per_pixel; higher
    --rpp amortizes the per-frame boundary machinery (the round-2 campaign
    measured 1024 spp at 1080p falling 344 s -> ~45 s). --nee flips the
    flag-gated next-event estimator on for a time-to-QUALITY comparison
    (equal spp, ~6-18x lower variance on enclosed lights — validated
    unbiased by scripts/validate_nee.py)."""
    import dataclasses as dc

    from ray_tracer_2_tpu.config import RenderParams
    from ray_tracer_2_tpu.engine.renderer import Renderer

    spp = 1024
    rpp = max(args.rpp, 1)
    n_frames = max(spp // rpp, 1)
    metric = "cornell_1024spp_wallclock" + ("_nee" if args.nee else "")
    host = named_scene("cornell")
    p = RenderParams(width=args.width, height=args.height,
                     bounces=args.bounces, rays_per_pixel=rpp,
                     skybox=True, frames=0, nee=args.nee)
    r = Renderer(lanes=args.lanes, unroll=args.unroll, mesh=None)

    batch = max(min(args.batch, n_frames), 1)
    guard = _hang_guard(2400, "first compile/warmup", metric)
    if batch > 1:
        r.render_batch(host.render_scene, dc.replace(p, frames=0), batch)
    else:
        r.render(host.render_scene, dc.replace(p, frames=0))
    r.framebuffer.block_until_ready()
    guard.set()
    # reset accumulation after warmup (frames=0 overwrites anyway)
    t0 = time.perf_counter()
    rays = 0.0
    f = 0
    while f < n_frames:
        k = min(batch, n_frames - f)
        if k > 1:
            r.render_batch(host.render_scene, dc.replace(p, frames=f), k)
        else:
            r.render(host.render_scene, dc.replace(p, frames=f))
        rays += float(r.last_segments)
        f += k
    r.framebuffer.block_until_ready()
    dt = time.perf_counter() - t0
    print(json.dumps({
        "metric": metric, "value": round(dt, 1), "unit": "s",
        "spp": spp, "rpp": rpp, "batch": batch, "device": args.device,
        "resolution": f"{args.width}x{args.height}",
        "mrays_per_s": round(rays / dt / 1e6, 2)}))
    return 0


def bench_sharded(host, p, args):
    """Row-sharded multi-device bench (parallel/sharding.py). On a one-card
    host this degenerates to mesh=1 == the unsharded number. Returns
    (n_chips, aggregate Mrays/s)."""
    import jax
    from ray_tracer_2_tpu.parallel.sharding import (
        make_render_mesh, render_frame_sharded, replicate_scene,
        shard_framebuffer,
    )
    import jax.numpy as jnp

    spp_axis = max(getattr(args, "mesh_spp", 1) or 1, 1)
    n = min(args.mesh, len(jax.devices()))
    if spp_axis > 1:
        from ray_tracer_2_tpu.parallel.sharding import (
            make_render_mesh2d, render_frame_hybrid_sharded)
        rows = max(n // spp_axis, 1)
        while args.height % rows:  # row blocks must divide the image height
            rows -= 1
        mesh = make_render_mesh2d(rows, spp_axis)
        n = rows * spp_axis
    else:
        while args.height % n:
            n -= 1
        mesh = make_render_mesh(n)
    scene = replicate_scene(host.render_scene, mesh)
    fb = shard_framebuffer(jnp.zeros((args.height, args.width, 4),
                                     jnp.float32), mesh)

    @jax.jit
    def step(fb, f):
        if spp_axis > 1:
            return render_frame_hybrid_sharded(
                scene, fb, f, mesh=mesh, width=args.width,
                height=args.height, bounces=args.bounces,
                rays_per_pixel=args.rpp, skybox=True)
        return render_frame_sharded(
            scene, fb, f, 100.0, mesh=mesh, width=args.width,
            height=args.height, bounces=args.bounces,
            rays_per_pixel=args.rpp, skybox=True)

    for f in range(args.warmup):
        fb, segs = step(fb, jnp.int32(f))
    fb.block_until_ready()

    t0 = time.perf_counter()
    seg_counts = []
    for f in range(args.warmup, args.warmup + args.frames):
        fb, segs = step(fb, jnp.int32(f))
        seg_counts.append(segs)  # device scalar; float() would sync per frame
    fb.block_until_ready()
    dt = time.perf_counter() - t0
    return n, sum(float(s) for s in seg_counts) / dt / 1e6


if __name__ == "__main__":
    main()

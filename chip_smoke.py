#!/usr/bin/env python
"""Smoke check of the path tracer on the GPU, through the entry points a
user calls, at full size (1920x1080, 5 bounces).

    python chip_smoke.py            # one card: every phase below
    python chip_smoke.py --multi    # four cards: the row-sharded frame and
                                    # the rows x spp mesh, against one card

Phases (one card):
  device    platform check (no CPU fallback), versions, XLA_FLAGS, card
  numerics  f16 child-bound decode over all 65,536 patterns; the completion
            log's pixel-id bitcast round trip
  goldens   the asset-free goldens, flip-aware against their CPU pins
  mainpath  the procedural atrium at 1080p (rpp 1, then rpp 32),
            random_balls and room; one band against the CPU backend
            (0 and 1 bounces pixel for pixel, full depth by segments)
  spheres   the whole-path small-scene kernel against the XLA megakernel,
            and their converged agreement on room
  entry     Engine.update/save_render and ``python -m ray_tracer_2_tpu``

Every phase prints its numbers; any failed phase exits non-zero without
the result line. The last line of a passing run is one JSON object with
the device as JAX reports it.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out" / "chip_smoke"

#: goldens that need no asset file (tests/goldens/*.npz, CPU pins)
GOLDENS = ("metal", "metal_aa", "balls", "room", "random_balls", "bugatti")

# Tolerances. The goldens and the band reference are CPU renders; on the
# card XLA contracts multiply-adds into FMAs and sums reduce in another
# order, so a hit/miss or russian-roulette decision near a threshold can
# flip and re-route one pixel's whole path. Such flips are few and large;
# everything else agrees to float noise. Hence the two-part gates below.
FLIP_DIFF = 1e-2        # a pixel differing by more than this has flipped
MAX_FLIP_FRAC = 0.01    # ... and at most 1% of pixels may flip
# random_balls' paths cross many glass spheres, each refraction one more
# threshold: its 4-frame pin flips 1.08% on an H100 with the pin's own
# implementation (the XLA megakernel) and 1.29% with the whole-path kernel
# even on the CPU, so its limit is 1.5%
GOLDEN_MAX_FLIP = {"random_balls": 0.015}
MAX_REST_RMSE = 1e-3    # RMSE over the pixels that did not flip
PIXEL_TOL = 1e-3        # band / kernel pixel agreement (max channel)
MIN_PIXEL_FRAC = 0.98   # ... for at least 98% of the pixels
SEG_TOL = 0.01          # segment counts agree within 1% (same paths)


@dataclasses.dataclass
class Sizes:
    width: int = 1920
    height: int = 1080
    bounces: int = 5
    band_rows: tuple = (532, 16)      # (first row, rows) of the CPU band
    conv: tuple = (128, 72, 4, 16, 64)  # W, H, rpp, frame checkpoints


class Failed(Exception):
    pass


def check(ok: bool, what: str) -> None:
    print(f"    {'ok  ' if ok else 'FAIL'} {what}", flush=True)
    if not ok:
        raise Failed(what)


def timed(fn):
    t0 = time.perf_counter()
    out = fn()
    import jax
    jax.block_until_ready(out)
    return out, time.perf_counter() - t0


def flip_aware(img, ref):
    """(flip fraction, RMSE over non-flipped pixels) of two (H, W, >=3)
    images, clipped to [0, 4] like tests/test_goldens.py."""
    import numpy as np
    a = np.clip(np.asarray(img, np.float64)[..., :3], 0, 4)
    b = np.clip(np.asarray(ref, np.float64)[..., :3], 0, 4)
    d = np.abs(a - b).max(axis=-1)
    flip = d > FLIP_DIFF
    rest = ((a - b) ** 2)[~flip]
    return float(flip.mean()), float(np.sqrt(rest.mean())) if rest.size \
        else 0.0


def pixel_frac(img, ref, tol=PIXEL_TOL):
    import numpy as np
    d = np.abs(np.asarray(img) - np.asarray(ref)).max(axis=-1)
    return float((d <= tol).mean()), float(d.max())


def host_scene(name: str):
    from ray_tracer_2_tpu.scene import scenes
    from ray_tracer_2_tpu.scene.render_scene import instantiate_scene
    return instantiate_scene(getattr(scenes, name)())


# ----------------------------------------------------------------- phases

def phase_device(sz: Sizes) -> None:
    import jax
    import jaxlib
    from ray_tracer_2_tpu.utils.device import card_name_and_power
    print(f"    jax {jax.__version__}, jaxlib {jaxlib.__version__}, "
          f"devices {jax.devices()}")
    print(f"    XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    print(f"    card: {card_name_and_power()}")


def phase_numerics(sz: Sizes) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np
    from ray_tracer_2_tpu.kernels.megakernel import (
        decode_log_ids, encode_log_ids, f16_bits_to_f32)

    bits = np.arange(65536, dtype=np.uint32)
    want = bits.astype(np.uint16).view(np.float16).astype(np.float32)
    # both halves of a packed word, as unpack_child_aabbs reads them
    packed = (bits[::-1] << 16) | bits
    lo, hi = jax.jit(lambda u: (f16_bits_to_f32(u & 0xFFFF),
                                f16_bits_to_f32(u >> 16)))(
        jnp.asarray(packed))
    for got, ref in ((np.asarray(lo), want), (np.asarray(hi), want[::-1])):
        nan = np.isnan(ref)
        bad = int((np.isnan(got) != nan).sum()
                  + (got[~nan].view(np.uint32)
                     != ref[~nan].view(np.uint32)).sum())
        sub = (bits & 0x7C00) == 0
        print(f"    f16 decode: {bad} of 65536 patterns differ from numpy "
              f"({int(sub.sum())} subnormal/zero patterns)")
        check(bad == 0, "f16 child-bound decode is exact, subnormals kept")

    ids = np.concatenate([
        np.arange(0, 4096, dtype=np.int32),
        np.asarray([1920 * 1080 - 1, 2**23 - 1], np.int32),
        np.random.default_rng(0).integers(0, 2**23, 65536).astype(np.int32)])
    perm = np.random.default_rng(1).permutation(ids.size).astype(np.int32)

    @jax.jit
    def round_trip(ids, perm):
        # the log's path: payload row, compaction take, reassembly sort
        payload = jnp.concatenate([jnp.zeros((1, ids.size)),
                                   encode_log_ids(ids)[None]], axis=0)
        moved = jnp.take(payload, perm, axis=1)
        _, back = jax.lax.sort((perm, moved[1]), num_keys=1)
        return decode_log_ids(back)

    got = np.asarray(round_trip(jnp.asarray(ids), jnp.asarray(perm)))
    bad = int((got != ids).sum())
    print(f"    log id round trip: {bad} of {ids.size} ids changed")
    check(bad == 0, "completion-log pixel ids survive the device round trip")


def phase_goldens(sz: Sizes) -> None:
    """Each golden through Renderer(mesh=None), flip-aware against its CPU
    pin. Scenes the whole-path kernel routes are also rendered through the
    XLA megakernel (the pins' own implementation, which isolates the card's
    arithmetic); both renders are gated."""
    import numpy as np
    from ray_tracer_2_tpu.config import RenderParams
    from ray_tracer_2_tpu.engine.renderer import Renderer

    def render(host, p, frames):
        r = Renderer(mesh=None)
        t0 = time.perf_counter()
        for f in range(frames):
            fb = r.render(host.render_scene, dataclasses.replace(p, frames=f))
        return np.asarray(fb), time.perf_counter() - t0

    bad = []
    for name in GOLDENS:
        with np.load(ROOT / "tests" / "goldens" / f"{name}.npz") as z:
            golden = z["framebuffer"]
            cfg = {k: int(z[k]) for k in ("width", "height", "bounces",
                                          "frames")}
            flags = {k: bool(int(z[k])) for k in ("nee", "antialias")
                     if k in z}
        host = host_scene(name.removesuffix("_aa"))
        p = RenderParams(width=cfg["width"], height=cfg["height"],
                         bounces=cfg["bounces"], rays_per_pixel=1,
                         skybox=True, **flags)
        routed = Renderer(mesh=None)._use_pallas_spheres(host.render_scene, p)
        paths = ("kernel", "XLA") if routed else ("XLA",)
        for path in paths:
            if path == "XLA" and routed:
                os.environ["RT2_PALLAS_SPHERES"] = "0"   # the user override
            try:
                fb, dt = render(host, p, cfg["frames"])
            finally:
                if path == "XLA" and routed:
                    del os.environ["RT2_PALLAS_SPHERES"]
            flip, rest = flip_aware(fb, golden)
            tag = ", routed" if (path == "kernel") == routed else ""
            print(f"    {name} ({path}{tag}): {cfg['width']}x{cfg['height']} "
                  f"{cfg['frames']} frames in {dt:.1f} s (compile "
                  f"included); flipped {flip:.4%}, rest RMSE {rest:.3e}")
            limit = GOLDEN_MAX_FLIP.get(name, MAX_FLIP_FRAC)
            if not (flip <= limit and rest < MAX_REST_RMSE):
                bad.append(f"{name} ({path})")
    # every golden prints its numbers before the phase decides
    check(not bad, f"goldens: <= 1% flipped pixels (random_balls 1.5%), "
                   f"rest RMSE < 1e-3 (failed: {bad or 'none'})")


def _frames(r, rs, p, frames):
    """Render ``frames`` (RNG frame ids) through Renderer.render; returns
    the last framebuffer, per-frame wall seconds and segment counts."""
    import numpy as np
    times, segs = [], []
    fb = None
    for f in frames:
        fb, dt = timed(lambda: r.render(rs, dataclasses.replace(p, frames=f)))
        times.append(dt)
        segs.append(float(r.last_segments))
    return np.asarray(fb), times, segs


def _image_ok(name, img, segs):
    import numpy as np
    finite = bool(np.isfinite(img).all())
    mean = float(img[..., :3].mean())
    check(finite and mean > 1e-3 and min(segs) > 0,
          f"{name}: finite, not black (mean {mean:.4f}), segments > 0")


def phase_mainpath(sz: Sizes) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np
    from ray_tracer_2_tpu.config import RenderParams
    from ray_tracer_2_tpu.engine.renderer import (Renderer, render_frame,
                                                  render_sample)

    W, H, B = sz.width, sz.height, sz.bounces
    atrium = host_scene("sponza").render_scene
    r = Renderer(mesh=None)
    p1 = RenderParams(width=W, height=H, bounces=B, rays_per_pixel=1)
    args, kwargs = r.frame_call(atrium, p1)
    compiled, dt = timed(
        lambda: render_frame.lower(*args, **kwargs).compile())
    print(f"    atrium frame step: compiled in {dt:.1f} s")
    ma = compiled.memory_analysis()
    if ma is not None:
        print("    frame step memory: "
              + ", ".join(f"{k} {getattr(ma, k) / 2**20:.1f} MiB"
                          for k in ("argument_size_in_bytes",
                                    "output_size_in_bytes",
                                    "temp_size_in_bytes",
                                    "generated_code_size_in_bytes")
                          if hasattr(ma, k)))
    img, times, segs = _frames(r, atrium, p1, range(3))
    print(f"    atrium {W}x{H} rpp 1: first frame {times[0]:.2f} s, then "
          f"{', '.join(f'{t * 1e3:.1f}' for t in times[1:])} ms; "
          f"segments {segs}")
    _image_ok("atrium rpp 1", img, segs)

    p32 = dataclasses.replace(p1, rays_per_pixel=32)
    img, times, segs = _frames(r, atrium, p32, range(3, 5))
    print(f"    atrium {W}x{H} rpp 32: first frame {times[0]:.2f} s "
          f"(compile included), then {times[1] * 1e3:.1f} ms; "
          f"segments {segs}")
    _image_ok("atrium rpp 32", img, segs)

    for name in ("random_balls", "room"):
        rs = host_scene(name).render_scene
        img, times, segs = _frames(Renderer(mesh=None), rs, p1, range(2))
        print(f"    {name} {W}x{H} rpp 1: first frame {times[0]:.2f} s "
              f"(compile included), then {times[1] * 1e3:.1f} ms; "
              f"segments {segs}")
        _image_ok(name, img, segs)

    # one band of the atrium frame on the card and on the CPU backend, at
    # 0 bounces, 1 bounce and the full depth. The first two must agree
    # pixel for pixel (>= 98% within 1e-3) with segments within 1%. At the
    # full depth only the segment counts are held to 1%: this scene's
    # diffuse bounces start ON the surface they leave, 800 model units
    # from the origin, where one ulp (6e-5) exceeds the reference's
    # self-hit epsilon (1e-5), so whether a bounce re-hits its own
    # triangle is decided by rounding. On the CPU alone, a one-ulp change
    # of the instance transform leaves 0 bounces exact and moves ~21% of
    # the pixels at 2 bounces; XLA's FMA contraction on the card does the
    # same, so the full-depth pixel match is printed, not gated.
    row0, rows = sz.band_rows
    depths = (0, 1, B)
    outs = []
    for dev in (jax.devices()[0], jax.devices("cpu")[0]):
        with jax.default_device(dev):
            rs_d = jax.device_put(atrium, dev)
            t0 = time.perf_counter()
            res = []
            for bounces in depths:
                img, seg = jax.jit(lambda s, b=bounces: render_sample(
                    s, jnp.int32(0), jnp.float32(1.0), width=W, height=H,
                    bounces=b, rays_per_pixel=1, skybox=True, debug_mode=0,
                    tile_rows=64, row_start=row0, rows=rows))(rs_d)
                res.append((np.asarray(img), float(seg)))
            outs.append(res)
            print(f"    band rows {row0}-{row0 + rows - 1} on "
                  f"{dev.platform}: bounces {depths} in "
                  f"{time.perf_counter() - t0:.1f} s (compile included)")
    for bounces, (ig, sg), (ic, sc) in zip(depths, *outs):
        frac, dmax = pixel_frac(ig, ic)
        seg_ok = abs(sg - sc) <= SEG_TOL * sc
        print(f"    band {bounces} bounces: {frac:.4%} of pixels within "
              f"{PIXEL_TOL} (max {dmax:.3e}); segments {sg:.0f} vs {sc:.0f}")
        if bounces < B:
            check(frac >= MIN_PIXEL_FRAC and seg_ok,
                  f"band {bounces} bounces: >= 98% of pixels within 1e-3 "
                  f"of the CPU, segments within 1%")
        else:
            check(seg_ok, f"band {bounces} bounces: segments within 1% of "
                          f"the CPU (pixels rounding-determined, see above)")


def _sphere_scenes():
    """Scenes Renderer routes to the whole-path kernel on this card."""
    from ray_tracer_2_tpu.config import RenderParams
    from ray_tracer_2_tpu.engine.renderer import Renderer
    p = RenderParams(width=16, height=16, bounces=1, rays_per_pixel=1)
    return [n for n in ("metal", "balls", "room", "random_balls")
            if Renderer(mesh=None)._use_pallas_spheres(
                host_scene(n).render_scene, p)]


def phase_spheres(sz: Sizes) -> None:
    import statistics

    import jax
    import jax.numpy as jnp
    import numpy as np
    from ray_tracer_2_tpu.engine.renderer import render_sample

    routed = _sphere_scenes()
    print(f"    routed to the kernel: {routed or 'none'}")
    W, H, B = sz.width, sz.height, sz.bounces

    def render(rs, kernel, frames, width, height, rpp):
        return render_sample(
            rs, frames, jnp.float32(1.0), width=width, height=height,
            bounces=B, rays_per_pixel=rpp, skybox=True, debug_mode=0,
            tile_rows=64, pallas_spheres=kernel)

    for name in routed:
        rs = host_scene(name).render_scene
        res, ms = {}, {}
        for kernel in (True, False):
            fn = jax.jit(lambda s, f, k=kernel: render(s, k, f, W, H, 1))
            res[kernel], _ = timed(lambda: fn(rs, jnp.int32(1)))
            ts = [timed(lambda: fn(rs, jnp.int32(f)))[1]
                  for f in range(2, 5)]
            ms[kernel] = statistics.median(ts) * 1e3
        (ik, sk), (ix, sx) = res[True], res[False]
        frac, dmax = pixel_frac(ik, ix)
        print(f"    {name} {W}x{H} rpp 1: kernel {ms[True]:.2f} ms, XLA "
              f"{ms[False]:.2f} ms (median of 3); {frac:.4%} of pixels "
              f"within {PIXEL_TOL} (max {dmax:.3e}); segments "
              f"{float(sk):.0f} vs {float(sx):.0f}")
        check(frac >= MIN_PIXEL_FRAC
              and abs(float(sk) - float(sx)) <= SEG_TOL * float(sx),
              f"{name}: kernel agrees with the XLA megakernel")

    # converged agreement (no sub-pixel jitter, so every spp of a pixel
    # shares one primary ray): an FMA-resolved grazing edge differs at
    # every spp and never converges — counted as the flip class; the rest
    # is two Monte-Carlo estimators of one integral, rmse^2 = b^2 + c/spp,
    # whose fitted floor b is the real bias. room has glass and triangles,
    # random_balls glass and the shared-term sphere math.
    cw, ch, rpp, *ckpts = sz.conv
    spps = [c * rpp for c in ckpts]
    for name in ("room", "random_balls"):
        if name not in routed:
            continue
        rs = host_scene(name).render_scene

        def accum(kernel):
            @jax.jit
            def run():
                outs, acc, lo = [], jnp.zeros((ch, cw, 4)), 0
                for hi in ckpts:
                    acc = jax.lax.fori_loop(
                        lo, hi, lambda f, a: a + render(
                            rs, kernel, jnp.int32(f), cw, ch, rpp)[0], acc)
                    outs.append(acc / hi)
                    lo = hi
                return outs
            return [np.asarray(o, np.float64)[..., :3] for o in run()]

        (p_imgs, x_imgs), dt = timed(lambda: (accum(True), accum(False)))
        diffs = [a - b for a, b in zip(p_imgs, x_imgs)]
        a_prev = np.abs(diffs[-2]).max(axis=-1)
        a_last = np.abs(diffs[-1]).max(axis=-1)
        flip = (a_last > 0.05) & (a_last > 0.7 * a_prev) & (a_prev > 0.05)
        keep = ~flip[..., None]
        bulk = [float(np.sqrt((d * d * keep).sum() / (keep.sum() * 3)))
                for d in diffs]
        M, N = spps[-2], spps[-1]
        c = (bulk[-2] ** 2 - bulk[-1] ** 2) / (1.0 / M - 1.0 / N)
        floor = float(np.sqrt(max(bulk[-1] ** 2 - c / N, 0.0)))
        print(f"    {name} converged {cw}x{ch} at {spps} spp in {dt:.1f} s: "
              f"flip class {flip.mean():.4%}, bulk RMSE {bulk}, bias floor "
              f"{floor:.3e}")
        check(flip.mean() < 0.01 and floor < 0.01,
              f"{name} converged, kernel vs XLA: flip class < 1%, bias "
              f"floor < 1%")


def phase_entry(sz: Sizes) -> None:
    import numpy as np
    from ray_tracer_2_tpu.__main__ import main as cli_main
    from ray_tracer_2_tpu.engine import Engine
    from ray_tracer_2_tpu.engine.export import read_png
    from ray_tracer_2_tpu.scene.scenes import SceneName

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    eng_png, cli_png = OUT_DIR / "engine_room.png", OUT_DIR / "cli_room.png"
    t0 = time.perf_counter()
    eng = Engine(width=sz.width, height=sz.height,
                 initial_scene=SceneName.ROOM, block_on_initial_scene=True)
    for _ in range(4):
        eng.update(dt=0.016)
    eng.save_render(eng_png)
    print(f"    Engine room: 4 updates + save_render in "
          f"{time.perf_counter() - t0:.1f} s; stats {eng.stats}")
    t0 = time.perf_counter()
    rc = cli_main(["--scene", "room", "--spp", "8", "--width",
                   str(sz.width), "--height", str(sz.height), "-o",
                   str(cli_png), "--log-every", "0"])
    print(f"    python -m ray_tracer_2_tpu --scene room --spp 8: rc {rc} in "
          f"{time.perf_counter() - t0:.1f} s")
    check(rc == 0, "CLI render exits 0")
    for path in (eng_png, cli_png):
        img = read_png(path)
        check(img.shape == (sz.height, sz.width, 3) and img.max() > 0,
              f"{path.name} decodes to a {sz.width}x{sz.height} image")


def _mesh_gate(what, img, ref, seg, ref_seg, bounces, full_depth):
    """A multi-card render against its one-card reference. At one bounce:
    max abs diff <= 1e-5 or, when the cards' programs fuse differently,
    the flip-aware gate; at the full depth only the segment counts (past
    the first bounce the atrium's paths are decided by rounding, see
    phase_mainpath)."""
    import numpy as np
    diff = float(np.abs(np.asarray(img) - np.asarray(ref)).max())
    flip, rest = flip_aware(img, ref)
    seg_ok = abs(seg - ref_seg) <= SEG_TOL * ref_seg
    print(f"    {what}, {bounces} bounces: max abs diff {diff:.3e}, flipped "
          f"{flip:.4%}, rest RMSE {rest:.3e}; segments {seg:.0f} vs "
          f"{ref_seg:.0f}")
    if full_depth:
        check(seg_ok, f"{what}, {bounces} bounces: segments within 1%")
        return
    exact = diff <= 1e-5
    print(f"    gate used: {'max abs diff' if exact else 'flip-aware'}")
    check(seg_ok and (exact or (flip <= MAX_FLIP_FRAC
                                and rest < MAX_REST_RMSE)),
          f"{what}, {bounces} bounce: matches one card, segments within 1%")


def phase_multi(sz: Sizes) -> None:
    """Four cards: the atrium frame through Renderer's auto rows mesh
    against Renderer(mesh=None) on card 0, per-band segments, and a 2x2
    rows x spp mesh against the composed single-device frames; each at
    one bounce (pixels) and at the full depth (segments, frame time)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from ray_tracer_2_tpu.config import RenderParams
    from ray_tracer_2_tpu.engine.renderer import Renderer, render_sample
    from ray_tracer_2_tpu.parallel.sharding import (
        make_render_mesh2d, render_frame_hybrid_sharded, replicate_scene,
        shard_framebuffer)

    n = len(jax.devices())
    check(n == 4, f"four cards visible (found {n})")
    W, H, B = sz.width, sz.height, sz.bounces
    atrium = host_scene("sponza").render_scene

    for bounces in (1, B):
        p = RenderParams(width=W, height=H, bounces=bounces,
                         rays_per_pixel=1)
        auto = Renderer()
        auto.ensure_framebuffer(W, H)
        check(auto.mesh is not None and auto.mesh.size == 4,
              "Renderer adopts a 4-way rows mesh")
        img_m, t_m, s_m = _frames(auto, atrium, p, range(4))
        img_1, t_1, s_1 = _frames(Renderer(mesh=None), atrium, p, range(4))
        print(f"    atrium {W}x{H}, {bounces} bounces: 4-card mesh "
              f"{', '.join(f'{t * 1e3:.1f}' for t in t_m[1:])} ms/frame vs "
              f"one card {', '.join(f'{t * 1e3:.1f}' for t in t_1[1:])} "
              f"ms/frame (first frames with compile: {t_m[0]:.1f} s, "
              f"{t_1[0]:.1f} s)")
        _mesh_gate("rows mesh vs one card after 4 frames", img_m, img_1,
                   sum(s_m), sum(s_1), bounces, bounces == B)

    # the frame in four bands of H/4 rows on card 0: segments per band
    rows = H // 4
    band = jax.jit(lambda s, r0: render_sample(
        s, jnp.int32(0), jnp.float32(1.0), width=W, height=H, bounces=B,
        rays_per_pixel=1, skybox=True, debug_mode=0, tile_rows=64,
        row_start=r0, rows=rows))
    for i in range(4):
        (_, seg), dt = timed(lambda: band(atrium, jnp.int32(i * rows)))
        print(f"    band {i} (rows {i * rows}-{(i + 1) * rows - 1}) on card "
              f"0: segments {float(seg):.0f}, {dt * 1e3:.1f} ms"
              + (" (compile included)" if i == 0 else ""))

    # 2x2 rows x spp: round 0 averages RNG frames 0 and 1, composed here
    # from single-card renders as tests/test_multidevice.py does
    mesh = make_render_mesh2d(2, 2)
    scene_m = replicate_scene(atrium, mesh)
    for bounces in (1, B):
        want, segs = 0.0, 0.0
        for f in range(2):
            img, seg = render_sample(
                atrium, jnp.int32(f), jnp.float32(1.0), width=W, height=H,
                bounces=bounces, rays_per_pixel=1, skybox=True,
                debug_mode=0, tile_rows=64)
            want, segs = want + np.asarray(img) * 0.5, segs + float(seg)
        fb = shard_framebuffer(jnp.zeros((H, W, 4), jnp.float32), mesh)
        (out, seg), dt = timed(lambda: render_frame_hybrid_sharded(
            scene_m, fb, 0, mesh=mesh, width=W, height=H, bounces=bounces,
            rays_per_pixel=1, skybox=True, tile_rows=64))
        print(f"    2x2 rows x spp, {bounces} bounces: {dt:.1f} s (compile "
              f"included)")
        _mesh_gate("2x2 rows x spp vs composed one-card frames", out, want,
                   float(seg), segs, bounces, bounces == B)


PHASES = {"device": phase_device, "numerics": phase_numerics,
          "goldens": phase_goldens, "mainpath": phase_mainpath,
          "spheres": phase_spheres, "entry": phase_entry}


def run(phases, sz: Sizes) -> list[str]:
    """Run the named phases in order; returns the names that failed."""
    failed = []
    for name in phases:
        t0 = time.perf_counter()
        print(f"[{name}]", flush=True)
        try:
            PHASES.get(name, phase_multi)(sz)
        except Exception as e:  # every phase runs; any failure fails all
            failed.append(name)
            if not isinstance(e, Failed):
                traceback.print_exc()
        print(f"[{name}] {'FAILED' if name in failed else 'passed'} in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    return failed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="four-card phase only (row-sharded frame and the "
                         "rows x spp mesh, against one card)")
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated one-card phases to run "
                         f"(default: all of {','.join(PHASES)})")
    args = ap.parse_args(argv)
    phases = ["multi"] if args.multi else args.phases.split(",")
    unknown = set(phases) - set(PHASES) - {"multi"}
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")

    # the band reference renders on the CPU backend beside the GPU
    os.environ.setdefault("JAX_PLATFORMS", "cuda,cpu")
    import jax
    from ray_tracer_2_tpu.utils.compile_cache import enable_compile_cache
    from ray_tracer_2_tpu.utils.device import (card_name_and_power,
                                               require_gpu)

    info = require_gpu("chip_smoke.py")
    print(f"compile cache: {enable_compile_cache()}")
    t0 = time.perf_counter()
    failed = run(phases, Sizes())
    print(f"total {time.perf_counter() - t0:.1f} s; card: "
          f"{card_name_and_power()}", flush=True)
    if failed:
        print(f"chip_smoke: failed phases: {', '.join(failed)}",
              file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": info}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

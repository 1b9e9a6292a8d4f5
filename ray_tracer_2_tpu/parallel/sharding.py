"""Multi-device rendering over a jax.sharding.Mesh.

The reference is strictly single-GPU (engine.rs:91-114); this module is the
scaling layer it never had (SURVEY.md §2.3):

  * **Pixel-tile sharding** (default): the framebuffer is sharded by rows
    across the ``rows`` mesh axis; every chip traces only its own rows.
    Per-pixel counter RNG makes the tiles statistically independent, so the
    hot loop has **zero collectives** — sharded output is bit-identical to
    single-chip output.
  * **Sample (spp) sharding**: every chip renders the full image with a
    different RNG frame offset and partial sums are combined with one
    ``psum`` per frame — the better axis when the image is small but the
    sample budget is large (the analog of sequence-parallel reduction,
    SURVEY.md §5.7).
  * **Hybrid 2-D mesh** (``rows`` x ``spp``): both at once — row tiles
    across one mesh axis, RNG frame offsets across the other, one
    ``pmean`` over ``spp`` per frame (the dp x sp mesh shape).

All run under ``shard_map``; the one collective per frame (a psum of the
segment count, or the spp pmean) goes to NCCL. The cards of a host reach
each other all to all at one rate, so the mesh shape follows the algorithm
alone.

Every sharded entry point takes the SAME tuning knobs and feature flags as
the single-device ``render_frame`` (lanes/unroll/boundaries/log_cap/claim/
packet + nee/antialias/normal_maps/pallas_spheres) — a multi-chip run
executes the same tuned, full-featured kernels as a single-chip one.
``Renderer`` (engine/renderer.py) auto-adopts a rows mesh when more than
one device is visible, so the Engine/viewer loop is multi-chip by default.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ray_tracer_2_tpu.engine.renderer import render_sample
from ray_tracer_2_tpu.scene.render_scene import RenderScene

#: knobs forwarded verbatim to render_sample by every sharded entry point.
#: All are trace-time static (they shape the compiled kernel), so they ride
#: through shard_map as ordinary Python closure values.
_RENDER_KNOBS = ("tile_rows", "tile_cols", "lanes", "unroll", "shade_every",
                 "cohorts", "claim", "boundaries", "log_cap", "packet",
                 "normal_maps", "antialias", "nee", "pallas_spheres",
                 "debug_mode")


def _render_kw(kw: dict) -> dict:
    unknown = set(kw) - set(_RENDER_KNOBS)
    assert not unknown, f"unknown render knobs: {sorted(unknown)}"
    return kw


def make_render_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """1-D device mesh over the ``rows`` axis."""
    devices = list(devices if devices is not None else jax.devices())
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.array(devices), ("rows",))


def auto_mesh(height: int) -> Mesh | None:
    """The mesh ``Renderer`` adopts by default: a 1-D rows mesh over every
    visible device, trimmed so the framebuffer height divides evenly.
    Returns None when only one device is visible (single-chip path)."""
    devices = jax.devices()
    n = len(devices)
    while n > 1 and height % n != 0:
        n -= 1
    if n <= 1:
        return None
    return make_render_mesh(n)


def render_frame_sharded(scene: RenderScene, framebuffer: jax.Array,
                         frames: jax.Array, debug_scale: jax.Array, *,
                         mesh: Mesh, width: int, height: int, bounces: int,
                         rays_per_pixel: int, skybox: bool,
                         tile_rows: int = 8, **kw) -> jax.Array:
    """Render + accumulate one frame with the framebuffer row-sharded.

    framebuffer: (height, width, 4), height divisible by the mesh size.
    Returns (updated framebuffer with the same sharding, total traced
    segments across all chips — one psum, outside the pixel hot loop).
    ``**kw``: any knob/flag from ``_RENDER_KNOBS``."""
    n = mesh.shape["rows"]
    assert height % n == 0, f"height {height} not divisible by mesh size {n}"
    block = height // n
    kw = _render_kw(dict(kw, tile_rows=tile_rows))
    kw.setdefault("debug_mode", 0)

    # check_vma=False: the while_loop carries mix axis-varying values (row
    # offsets / RNG seeds derived from axis_index) with invariant inits, which
    # the VMA checker rejects; the computation itself is purely per-shard.
    @partial(jax.shard_map, mesh=mesh,
             in_specs=(P(), P("rows"), P(), P()),
             out_specs=(P("rows"), P()), check_vma=False)
    def step(scene, fb_block, frames, dscale):
        row0 = jax.lax.axis_index("rows") * block
        sample, segs = render_sample(
            scene, frames, dscale, width=width, height=height,
            bounces=bounces, rays_per_pixel=rays_per_pixel, skybox=skybox,
            row_start=row0, rows=block, **kw)
        w = jnp.where(frames >= 1, 1.0 / (frames.astype(jnp.float32) + 1.0), 1.0)
        return (fb_block * (1.0 - w) + sample * w,
                jax.lax.psum(segs, "rows"))

    return step(scene, framebuffer, jnp.int32(frames), jnp.float32(debug_scale))


def render_frame_spp_sharded(scene: RenderScene, framebuffer: jax.Array,
                             frames: jax.Array, *, mesh: Mesh, width: int,
                             height: int, bounces: int, rays_per_pixel: int,
                             skybox: bool, tile_rows: int = 8,
                             **kw) -> jax.Array:
    """Accumulate one *round* of N samples per pixel (N = mesh size): chip i
    renders RNG frame ``frames*N + i``, partial images are mean-reduced with
    one psum. The accumulation weight treats the round as N frames.
    Returns (framebuffer, total traced segments across the round)."""
    n = mesh.shape["rows"]
    kw = _render_kw(dict(kw, tile_rows=tile_rows))
    kw.setdefault("debug_mode", 0)

    @partial(jax.shard_map, mesh=mesh,
             in_specs=(P(), P(), P()),
             out_specs=(P(), P()), check_vma=False)
    def step(scene, fb, frames):
        my_frame = frames * n + jax.lax.axis_index("rows")
        sample, segs = render_sample(
            scene, my_frame, jnp.float32(1.0), width=width, height=height,
            bounces=bounces, rays_per_pixel=rays_per_pixel, skybox=skybox,
            **kw)
        mean = jax.lax.pmean(sample, "rows")
        # Blend a whole round: frames counts rounds of n samples.
        w = jnp.where(frames >= 1,
                      n / (frames.astype(jnp.float32) * n + n), 1.0)
        return fb * (1.0 - w) + mean * w, jax.lax.psum(segs, "rows")

    return step(scene, framebuffer, jnp.int32(frames))


def make_render_mesh2d(rows: int, spp: int, devices=None) -> Mesh:
    """2-D device mesh (``rows`` x ``spp``). ``spp`` carries the per-frame
    pmean; ``rows`` carries no collectives at all."""
    devices = list(devices if devices is not None else jax.devices())
    assert rows * spp <= len(devices), \
        f"mesh {rows}x{spp} needs {rows * spp} devices, have {len(devices)}"
    return Mesh(np.array(devices[:rows * spp]).reshape(rows, spp),
                ("rows", "spp"))


def render_frame_hybrid_sharded(scene: RenderScene, framebuffer: jax.Array,
                                frames: jax.Array, *, mesh: Mesh, width: int,
                                height: int, bounces: int,
                                rays_per_pixel: int, skybox: bool,
                                tile_rows: int = 8, **kw):
    """One accumulation ROUND over a 2-D (rows x spp) mesh: chip (i, j)
    renders only row block i at RNG frame ``frames*S + j``; the S samples
    of each block are mean-reduced with one ``pmean`` over the ``spp``
    axis and blended into the row-sharded framebuffer (``frames`` counts
    rounds of S samples, so the blend weight is the ordinary
    ``1/(frames+1)``). Returns (framebuffer, exact traced segments across
    the whole round — one psum over both axes)."""
    R, S = mesh.shape["rows"], mesh.shape["spp"]
    assert height % R == 0, f"height {height} not divisible by rows={R}"
    block = height // R
    kw = _render_kw(dict(kw, tile_rows=tile_rows))
    kw.setdefault("debug_mode", 0)

    @partial(jax.shard_map, mesh=mesh,
             in_specs=(P(), P("rows"), P()),
             out_specs=(P("rows"), P()), check_vma=False)
    def step(scene, fb_block, frames):
        row0 = jax.lax.axis_index("rows") * block
        my_frame = frames * S + jax.lax.axis_index("spp")
        sample, segs = render_sample(
            scene, my_frame, jnp.float32(1.0), width=width, height=height,
            bounces=bounces, rays_per_pixel=rays_per_pixel, skybox=skybox,
            row_start=row0, rows=block, **kw)
        mean = jax.lax.pmean(sample, "spp")
        w = jnp.where(frames >= 1,
                      1.0 / (frames.astype(jnp.float32) + 1.0), 1.0)
        return (fb_block * (1.0 - w) + mean * w,
                jax.lax.psum(segs, ("rows", "spp")))

    return step(scene, framebuffer, jnp.int32(frames))


# --------------------------------------------------------------------------
# jit-compiled mesh frame: the multi-chip twin of renderer.render_frame.
# The mesh and every kernel-shaping knob are static; the framebuffer is
# donated so accumulation stays in-place (sharded) in HBM.
# --------------------------------------------------------------------------
@partial(jax.jit, donate_argnums=(1,),
         static_argnames=("mesh", "width", "height", "bounces",
                          "rays_per_pixel", "skybox", "debug_mode",
                          "tile_rows", "tile_cols", "lanes", "unroll",
                          "shade_every", "cohorts", "normal_maps",
                          "pallas_spheres", "claim", "boundaries", "log_cap",
                          "antialias", "nee", "packet"))
def render_frame_mesh(scene: RenderScene, framebuffer: jax.Array,
                      frames: jax.Array, debug_scale: jax.Array, *,
                      mesh: Mesh, width: int, height: int, bounces: int,
                      rays_per_pixel: int, skybox: bool, debug_mode: int,
                      tile_rows: int, tile_cols: int | None = None,
                      lanes: int | None = None, unroll: int | None = None,
                      shade_every: int | None = None,
                      cohorts: int | None = None, normal_maps: bool = False,
                      pallas_spheres: bool = False, claim: str | None = None,
                      boundaries: int | None = None,
                      log_cap: int | None = None, antialias: bool = False,
                      nee: bool = False, packet: int | None = None):
    """Drop-in for ``render_frame`` on a rows mesh: same signature plus
    ``mesh``; same return (framebuffer, traced segments). The framebuffer
    must already be row-sharded over the mesh (``shard_framebuffer``)."""
    return render_frame_sharded(
        scene, framebuffer, frames, debug_scale, mesh=mesh, width=width,
        height=height, bounces=bounces, rays_per_pixel=rays_per_pixel,
        skybox=skybox, debug_mode=debug_mode, tile_rows=tile_rows,
        tile_cols=tile_cols, lanes=lanes, unroll=unroll,
        shade_every=shade_every, cohorts=cohorts, normal_maps=normal_maps,
        pallas_spheres=pallas_spheres, claim=claim, boundaries=boundaries,
        log_cap=log_cap, antialias=antialias, nee=nee, packet=packet)


@partial(jax.jit, donate_argnums=(1,),
         static_argnames=("mesh", "n_frames", "width", "height", "bounces",
                          "rays_per_pixel", "skybox", "debug_mode",
                          "tile_rows", "tile_cols", "lanes", "unroll",
                          "shade_every", "cohorts", "normal_maps",
                          "pallas_spheres", "claim", "boundaries", "log_cap",
                          "antialias", "nee", "packet"))
def render_frames_batched_mesh(scene: RenderScene, framebuffer: jax.Array,
                               frames0: jax.Array, debug_scale: jax.Array, *,
                               mesh: Mesh, n_frames: int, width: int,
                               height: int, bounces: int, rays_per_pixel: int,
                               skybox: bool, debug_mode: int, tile_rows: int,
                               tile_cols: int | None = None,
                               lanes: int | None = None,
                               unroll: int | None = None,
                               shade_every: int | None = None,
                               cohorts: int | None = None,
                               normal_maps: bool = False,
                               pallas_spheres: bool = False,
                               claim: str | None = None,
                               boundaries: int | None = None,
                               log_cap: int | None = None,
                               antialias: bool = False, nee: bool = False,
                               packet: int | None = None):
    """Multi-chip twin of ``renderer.render_frames_batched``: ``n_frames``
    progressive frames in ONE device program per chip (``lax.fori_loop``
    inside the shard), so sustained rendering pays the host->device dispatch
    cost once per batch instead of once per frame. Bit-identical to ``n_frames`` sequential ``render_frame_mesh``
    calls (same per-frame RNG seeds + 1/(frames+1) protocol,
    ray_tracer.wgsl:154-161). Returns (framebuffer, total segments)."""
    n = mesh.shape["rows"]
    assert height % n == 0, f"height {height} not divisible by mesh size {n}"
    block = height // n
    kw = dict(tile_rows=tile_rows, tile_cols=tile_cols, lanes=lanes,
              unroll=unroll, shade_every=shade_every, cohorts=cohorts,
              normal_maps=normal_maps, pallas_spheres=pallas_spheres,
              claim=claim, boundaries=boundaries, log_cap=log_cap,
              antialias=antialias, nee=nee, packet=packet,
              debug_mode=debug_mode)

    @partial(jax.shard_map, mesh=mesh,
             in_specs=(P(), P("rows"), P(), P()),
             out_specs=(P("rows"), P()), check_vma=False)
    def step(scene, fb_block, frames0, dscale):
        row0 = jax.lax.axis_index("rows") * block

        def body(i, carry):
            fb, segs = carry
            f = frames0 + i
            sample, s = render_sample(
                scene, f, dscale, width=width, height=height,
                bounces=bounces, rays_per_pixel=rays_per_pixel,
                skybox=skybox, row_start=row0, rows=block, **kw)
            w = jnp.where(f >= 1,
                          1.0 / (f.astype(jnp.float32) + 1.0), 1.0)
            return fb * (1.0 - w) + sample * w, segs + s

        fb, segs = jax.lax.fori_loop(
            0, n_frames, body, (fb_block, jnp.zeros((), jnp.float32)))
        return fb, jax.lax.psum(segs, "rows")

    return step(scene, framebuffer, jnp.int32(frames0),
                jnp.float32(debug_scale))


def replicate_scene(scene: RenderScene, mesh: Mesh) -> RenderScene:
    """Place the scene pytree replicated over the mesh."""
    sharding = NamedSharding(mesh, P())
    return jax.tree.map(lambda x: jax.device_put(x, sharding), scene)


def shard_framebuffer(fb: jax.Array, mesh: Mesh) -> jax.Array:
    return jax.device_put(fb, NamedSharding(mesh, P("rows", None, None)))

"""Tiled progressive renderer.

One ``jit``-compiled program renders a whole frame: the framebuffer is split
into row tiles (each a flat ray batch sized for good occupancy and a tight
per-tile bounce/traversal loop), ``lax.map`` walks the tiles, and the result
is blended into the accumulation buffer with the reference's progressive
weight ``1/(frames+1)`` (ray_tracer.wgsl:154-161). The framebuffer is donated,
so accumulation is in-place in HBM.

The reference re-uploads the whole scene every frame (ray_tracer.rs:397-419);
here the scene pytree is device-resident and only replaced when it actually
changes (scene switch / UI edit).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ray_tracer_2_tpu.config import DebugMode, RenderParams
from ray_tracer_2_tpu.kernels.trace import debug_trace_pixels
from ray_tracer_2_tpu.scene.render_scene import RenderScene

DEFAULT_TILE_ROWS = 64
#: most spheres a scene may have for the whole-path kernel. It beat the XLA
#: megakernel on every scene measured on the H100 (up to random_balls' 485
#: spheres, 2.5-40x at 1080p, PERF.md); 500 is the reference's own sphere
#: capacity (ray_tracer.rs:15-19).
SPHERE_KERNEL_CAP = 500
DEFAULT_TILE_COLS = 256


@partial(jax.jit, donate_argnums=(1,),
         static_argnames=("width", "height", "bounces", "rays_per_pixel",
                          "skybox", "debug_mode", "tile_rows", "tile_cols",
                          "lanes", "unroll", "shade_every", "cohorts",
                          "normal_maps", "pallas_spheres", "claim",
                          "boundaries", "log_cap", "antialias", "nee",
                          "packet"))
def render_frame(scene: RenderScene, framebuffer: jax.Array, frames: jax.Array,
                 debug_scale: jax.Array, *, width: int, height: int,
                 bounces: int, rays_per_pixel: int, skybox: bool,
                 debug_mode: int, tile_rows: int, tile_cols: int | None = None,
                 lanes: int | None = None, unroll: int | None = None,
                 shade_every: int | None = None, cohorts: int | None = None,
                 normal_maps: bool = False,
                 pallas_spheres: bool = False, claim: str | None = None,
                 boundaries: int | None = None, log_cap: int | None = None,
                 antialias: bool = False, nee: bool = False,
                 packet: int | None = None):
    """Render + accumulate one frame. framebuffer: (height, width, 4) f32.
    Returns (new framebuffer, traced-segment count scalar)."""
    sample, segments = render_sample(
        scene, frames, debug_scale, width=width, height=height,
        bounces=bounces, rays_per_pixel=rays_per_pixel, skybox=skybox,
        debug_mode=debug_mode, tile_rows=tile_rows, tile_cols=tile_cols,
        lanes=lanes, unroll=unroll, shade_every=shade_every,
        cohorts=cohorts, normal_maps=normal_maps,
        pallas_spheres=pallas_spheres, claim=claim, boundaries=boundaries,
        log_cap=log_cap, antialias=antialias, nee=nee, packet=packet)
    # Progressive average (ray_tracer.wgsl:154-161): frames <= 0 ⇒ overwrite.
    weight = jnp.where(frames >= 1, 1.0 / (frames.astype(jnp.float32) + 1.0), 1.0)
    return framebuffer * (1.0 - weight) + sample * weight, segments


@partial(jax.jit, donate_argnums=(1,),
         static_argnames=("n_frames", "width", "height", "bounces",
                          "rays_per_pixel", "skybox", "debug_mode",
                          "tile_rows", "tile_cols", "lanes", "unroll",
                          "shade_every", "cohorts", "normal_maps",
                          "pallas_spheres", "claim", "boundaries", "log_cap",
                          "antialias", "nee", "packet"))
def render_frames_batched(scene: RenderScene, framebuffer: jax.Array,
                          frames0: jax.Array, debug_scale: jax.Array, *,
                          n_frames: int, width: int, height: int,
                          bounces: int, rays_per_pixel: int, skybox: bool,
                          debug_mode: int, tile_rows: int,
                          tile_cols: int | None = None,
                          lanes: int | None = None, unroll: int | None = None,
                          shade_every: int | None = None,
                          cohorts: int | None = None,
                          normal_maps: bool = False,
                          pallas_spheres: bool = False,
                          claim: str | None = None,
                          boundaries: int | None = None,
                          log_cap: int | None = None,
                          antialias: bool = False, nee: bool = False,
                          packet: int | None = None):
    """``n_frames`` progressive frames in ONE device program: a
    ``lax.fori_loop`` carries the accumulation buffer, so sustained
    rendering pays the host→device dispatch cost once per batch instead of
    once per frame. Bit-identical to
    ``n_frames`` sequential ``render_frame`` calls: per-frame RNG seeds
    derive from the frame index and the accumulation weight is the
    reference protocol ``1/(frames+1)`` applied per frame
    (ray_tracer.wgsl:154-161). Returns (framebuffer, total segments)."""
    def body(i, carry):
        fb, segs = carry
        f = frames0 + i
        sample, s = render_sample(
            scene, f, debug_scale, width=width, height=height,
            bounces=bounces, rays_per_pixel=rays_per_pixel, skybox=skybox,
            debug_mode=debug_mode, tile_rows=tile_rows, tile_cols=tile_cols,
            lanes=lanes, unroll=unroll, shade_every=shade_every,
            cohorts=cohorts, normal_maps=normal_maps,
            pallas_spheres=pallas_spheres, claim=claim,
            boundaries=boundaries, log_cap=log_cap, antialias=antialias,
            nee=nee, packet=packet)
        w = jnp.where(f >= 1, 1.0 / (f.astype(jnp.float32) + 1.0), 1.0)
        return fb * (1.0 - w) + sample * w, segs + s

    return jax.lax.fori_loop(
        0, n_frames, body,
        (framebuffer, jnp.zeros((), jnp.float32)))


def render_sample(scene: RenderScene, frames, debug_scale, *, width: int,
                  height: int, bounces: int, rays_per_pixel: int,
                  skybox: bool, debug_mode: int, tile_rows: int,
                  tile_cols: int | None = None,
                  row_start=0, rows: int | None = None,
                  lanes: int | None = None, unroll: int | None = None,
                  shade_every: int | None = None, cohorts: int | None = None,
                  normal_maps: bool = False,
                  pallas_spheres: bool = False,
                  claim: str | None = None, boundaries: int | None = None,
                  log_cap: int | None = None,
                  antialias: bool = False, nee: bool = False,
                  packet: int | None = None) -> jax.Array:
    """Radiance for ``rows`` rows starting at ``row_start`` (no accumulation),
    (rows, width, 4). ``row_start`` may be traced (multi-chip row blocks);
    ``width``/``height`` always describe the FULL image (camera uv space).

    ``lanes``/``unroll``/``shade_every`` tune the persistent-lanes megakernel
    (the lit-render path); ``tile_rows``/``tile_cols`` shape the (tile_rows ×
    tile_cols) pixel blocks of the deterministic tiled DEBUG path only.
    Square-ish blocks matter there: a tile's wall-clock is its slowest ray's
    path, so tiles that miss the heavy geometry finish early instead of being
    chained to it across the full image width.
    """
    rows = height if rows is None else rows

    # Lit renders go through the persistent-lanes megakernel: one fixed lane
    # batch consumes the whole pixel queue, so per-pixel path-length variance
    # never stalls a tile (kernels/megakernel.py). Debug modes use the
    # deterministic tiled path below.
    from ray_tracer_2_tpu.kernels import megakernel

    if debug_mode == int(DebugMode.OFF) and pallas_spheres:
        # small scenes route to the whole-path GPU kernel
        # (kernels/pallas_spheres.py) — eligibility decided statically by
        # the caller (Renderer.render), never under tracing
        from ray_tracer_2_tpu.kernels.pallas_spheres import \
            render_spheres_pallas
        return render_spheres_pallas(
            scene, frames, width=width, height=height, bounces=bounces,
            rays_per_pixel=rays_per_pixel, skybox=skybox,
            row_start=row_start, rows=rows)

    if debug_mode == int(DebugMode.OFF):
        kw = {}
        if lanes is not None:
            kw["lanes"] = lanes
        if unroll is not None:
            kw["unroll"] = unroll
        if shade_every is not None:
            kw["shade_every"] = shade_every
        if cohorts is not None:
            kw["cohorts"] = cohorts
        if claim is not None:
            kw["claim"] = claim
        if boundaries is not None:
            kw["boundaries"] = boundaries
        if log_cap is not None:
            kw["log_cap"] = log_cap
        if packet is not None:
            kw["packet"] = packet
        return megakernel.render_persistent(
            scene, frames, width=width, height=height, bounces=bounces,
            rays_per_pixel=rays_per_pixel, skybox=skybox,
            row_start=row_start, rows=rows, normal_maps=normal_maps,
            antialias=antialias, nee=nee, **kw)

    tile_cols = width if tile_cols is None else tile_cols
    n_ty = -(-rows // tile_rows)
    n_tx = -(-width // tile_cols)
    pad_h = n_ty * tile_rows
    pad_w = n_tx * tile_cols

    def tile_fn(t):
        ty = t // n_tx
        tx = t % n_tx
        y0 = row_start + ty * tile_rows
        x0 = tx * tile_cols
        yy = jnp.broadcast_to((y0 + jnp.arange(tile_rows, dtype=jnp.int32)
                               )[:, None], (tile_rows, tile_cols)).reshape(-1)
        xx = jnp.broadcast_to((x0 + jnp.arange(tile_cols, dtype=jnp.int32)
                               )[None, :], (tile_rows, tile_cols)).reshape(-1)
        # clamp out-of-image pixels (right/bottom padding) to stay in range
        xx = jnp.minimum(xx, width - 1)
        color = debug_trace_pixels(scene, xx, yy, width=width, height=height,
                                   debug_mode=debug_mode,
                                   debug_scale=debug_scale)
        segs = jnp.zeros((), jnp.float32)
        return color.reshape(tile_rows, tile_cols, 4), segs

    tiles, segs = jax.lax.map(tile_fn, jnp.arange(n_ty * n_tx, dtype=jnp.int32))
    img = (tiles.reshape(n_ty, n_tx, tile_rows, tile_cols, 4)
           .transpose(0, 2, 1, 3, 4).reshape(pad_h, pad_w, 4))
    return img[:rows, :width], jnp.sum(segs)


class Renderer:
    """Host-facing wrapper: owns the accumulation buffer and render stats
    (ref RayTracer, ray_tracer.rs:49-236 — minus the per-frame re-upload)."""

    def __init__(self, tile_rows: int = DEFAULT_TILE_ROWS,
                 tile_cols: int | None = DEFAULT_TILE_COLS,
                 lanes: int | None = None, unroll: int | None = None,
                 shade_every: int | None = None, cohorts: int | None = None,
                 claim: str | None = None, boundaries: int | None = None,
                 log_cap: int | None = None, packet: int | None = None,
                 mesh="auto"):
        self.tile_rows = tile_rows
        self.tile_cols = tile_cols
        self.lanes = lanes
        self.unroll = unroll
        self.shade_every = shade_every
        self.cohorts = cohorts
        self.claim = claim
        self.boundaries = boundaries
        self.log_cap = log_cap
        self.packet = packet
        # ``mesh``: "auto" (default) adopts a 1-D rows mesh over every
        # visible device (SURVEY.md §2.3: the framebuffer tiled across
        # chips IN the real render loop, not a bench side path); a
        # jax.sharding.Mesh pins one explicitly; None forces single-device.
        self._mesh_arg = mesh
        self.mesh = None if mesh in ("auto", None) else mesh
        self.framebuffer: jax.Array | None = None
        self.last_segments: jax.Array | None = None  # traced rays last frame
        self._fb_shape: tuple | None = None
        self._psph_cache: dict = {}

    def _resolve_mesh(self, height: int):
        if self._mesh_arg == "auto":
            from ray_tracer_2_tpu.parallel.sharding import auto_mesh
            return auto_mesh(height)
        return self.mesh

    def ensure_framebuffer(self, width: int, height: int) -> None:
        if self._fb_shape != (height, width):
            self.mesh = self._resolve_mesh(height)
            fb = jnp.zeros((height, width, 4), jnp.float32)
            if self.mesh is not None:
                from ray_tracer_2_tpu.parallel.sharding import \
                    shard_framebuffer
                fb = shard_framebuffer(fb, self.mesh)
            self.framebuffer = fb
            self._fb_shape = (height, width)

    def _use_pallas_spheres(self, scene: RenderScene,
                            params: RenderParams) -> bool:
        """Static routing decision for the whole-path small-scene kernel
        (kernels/pallas_spheres.py): GPU backend only (it is compiled for
        the card; the Pallas interpreter is for tests), lit renders without
        normal maps, antialiasing or NEE, and scenes of spheres (at most
        RT2_PALLAS_SPHERE_CAP) plus small meshes without textures.
        RT2_PALLAS_SPHERES=0 forces the XLA megakernel."""
        import os
        if os.environ.get("RT2_PALLAS_SPHERES") == "0":
            return False
        if params.debug_mode != DebugMode.OFF or params.normal_maps \
                or params.antialias or params.nee:
            return False
        if jax.default_backend() != "gpu":
            return False
        key = id(scene)
        cached = self._psph_cache.get(key)
        if cached is None:
            from ray_tracer_2_tpu.kernels.pallas_spheres import eligible
            cap = int(os.environ.get("RT2_PALLAS_SPHERE_CAP",
                                     SPHERE_KERNEL_CAP))
            cached = eligible(scene) and scene.n_spheres <= cap
            self._psph_cache[key] = cached
        return cached

    def frame_call(self, scene: RenderScene, params: RenderParams):
        """The exact ``render_frame`` call ``render`` makes, as (args,
        kwargs) — exposed so tooling can ``render_frame.lower(*args,
        **kwargs)`` the shipping computation (chip_smoke.py reads its
        memory analysis)."""
        self.ensure_framebuffer(params.width, params.height)
        args = (scene, self.framebuffer, jnp.int32(params.frames),
                jnp.float32(max(params.debug_scale, 1)))
        kwargs = dict(
            width=params.width, height=params.height,
            bounces=int(params.bounces),
            rays_per_pixel=int(params.rays_per_pixel),
            skybox=bool(params.skybox),
            debug_mode=int(params.debug_mode),
            tile_rows=self.tile_rows, tile_cols=self.tile_cols,
            lanes=self.lanes, unroll=self.unroll,
            shade_every=self.shade_every, cohorts=self.cohorts,
            claim=self.claim, boundaries=self.boundaries,
            log_cap=self.log_cap, packet=self.packet,
            normal_maps=bool(getattr(params, "normal_maps", False)),
            antialias=bool(getattr(params, "antialias", False)),
            nee=bool(getattr(params, "nee", False)),
            pallas_spheres=self._use_pallas_spheres(scene, params),
        )
        if self.mesh is not None:
            # the sphere kernel takes a STATIC row_start
            # (pallas_spheres.py static_argnames); under the rows mesh the
            # per-chip row offset is traced (axis_index), so sphere scenes
            # run the XLA megakernel per chip instead
            kwargs["pallas_spheres"] = False
        return args, kwargs

    def render(self, scene: RenderScene, params: RenderParams) -> jax.Array:
        """Render one frame into the accumulation buffer; returns it.

        With more than one visible device the frame runs row-sharded over
        ``self.mesh`` (zero collectives in the hot loop; one psum for the
        segment count) — the multi-chip twin compiles from the same kernels
        with the same tuned knobs (parallel/sharding.py)."""
        args, kwargs = self.frame_call(scene, params)
        if self.mesh is not None:
            from ray_tracer_2_tpu.parallel.sharding import render_frame_mesh
            self.framebuffer, self.last_segments = render_frame_mesh(
                *args, mesh=self.mesh, **kwargs)
        else:
            self.framebuffer, self.last_segments = render_frame(
                *args, **kwargs)
        return self.framebuffer

    def render_batch(self, scene: RenderScene, params: RenderParams,
                     n_frames: int) -> jax.Array:
        """Render ``n_frames`` progressive frames (RNG frames
        ``params.frames .. params.frames + n_frames - 1``) in ONE device
        dispatch — bit-identical to ``n_frames`` sequential :meth:`render`
        calls, but paying the host->device dispatch gap once per batch.
        Routes through
        the rows mesh when one is adopted. ``last_segments`` holds the
        batch total."""
        args, kwargs = self.frame_call(scene, params)
        if self.mesh is not None:
            from ray_tracer_2_tpu.parallel.sharding import \
                render_frames_batched_mesh
            self.framebuffer, self.last_segments = render_frames_batched_mesh(
                *args, mesh=self.mesh, n_frames=n_frames, **kwargs)
        else:
            self.framebuffer, self.last_segments = render_frames_batched(
                *args, n_frames=n_frames, **kwargs)
        return self.framebuffer

    def read_framebuffer(self) -> np.ndarray:
        """Device → host readback (ref: app.rs:365-408 mapped-buffer path)."""
        assert self.framebuffer is not None
        return np.asarray(jax.device_get(self.framebuffer))

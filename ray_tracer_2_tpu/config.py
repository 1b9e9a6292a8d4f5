"""Render configuration — the Params uniform and engine constants.

The reference mutates one ``Params`` uniform per frame (app.rs:27-91) and
bakes capacities as compile-time consts (engine.rs:202, ray_tracer.rs:15-19).
Here the same knobs are one frozen dataclass: fields that change shapes or
compiled control flow are static (re-jit on change), fields read by the kernel
as data (frame counter, debug scale) travel as device scalars.
"""
from __future__ import annotations

import dataclasses
import enum

# Internal framebuffer (engine.rs:202): 1920x1080 RGBA float32.
RENDER_SIZE = (1920, 1080)

# Capacities (ray_tracer.rs:15-19). Here these are padding targets for SoA
# arrays, not hard buffer limits — scenes re-jit if they outgrow a bucket.
MAX_TEXTURES = 64


class DebugMode(enum.IntEnum):
    """Debug visualisations (ray_tracer.wgsl:136-142)."""

    OFF = 0
    NORMALS = 1
    DEPTH = 2
    TEX_COORDS = 3
    FOCUS_DST = 4
    NODES = 5
    TRIANGLES = 6
    NODES_AND_TRIANGLES = 7


@dataclasses.dataclass(frozen=True)
class RenderParams:
    """Per-frame render parameters (app.rs:27-41 ``Params``).

    ``frames`` follows the reference accumulation protocol
    (ray_tracer.wgsl:154-161, app.rs:43-57): ``-1``/``0`` ⇒ overwrite the
    framebuffer, ``>= 1`` ⇒ blend with weight ``1/(frames+1)``.
    """

    width: int = RENDER_SIZE[0]
    height: int = RENDER_SIZE[1]
    bounces: int = 5             # engine.rs:244-250 defaults
    rays_per_pixel: int = 1
    skybox: bool = True
    frames: int = 0
    accumulate: bool = True
    debug_mode: DebugMode = DebugMode.OFF
    debug_scale: int = 100
    #: Normal-map shading in the lit path. The reference STUBS this out
    #: (ray_tracer.wgsl:440-447 is a no-op TODO); off by default for
    #: reference parity, on = tangent-frame perturbation from map_Disp
    #: textures (sponza ships 22 of them).
    normal_maps: bool = False
    #: Next-event estimation: at every diffuse bounce, additionally sample
    #: one point on an emissive primitive and add its direct contribution
    #: through an explicit shadow query (surface emission on the following
    #: BSDF hit is suppressed to stay unbiased). Collapses variance on
    #: enclosed-light scenes (Cornell class) by an order of magnitude per
    #: sample. Reference-divergent physics path — off by default. On
    #: no-traversal scenes the shadow query is one inline prepass; on
    #: BVH-traversal scenes it runs as a SHADOW SEGMENT through the
    #: ordinary traversal machinery (kernels/megakernel.py nee_mode).
    #: A no-op when the scene has no emissive primitives.
    nee: bool = False
    #: Sub-pixel anti-aliasing: jitter each sample's camera ray uniformly
    #: over the pixel footprint (box filter). The reference has NO pixel
    #: jitter at all (uv comes straight from the pixel index,
    #: ray_tracer.wgsl:479) so geometry edges never converge past the pixel
    #: grid. Off by default for reference parity; the flag adds two uniform
    #: draws per sample, so RNG streams differ from the reference when on.
    antialias: bool = False
    #: Adaptive motion degradation: instead of the reference's fixed half
    #: resolution while moving (app.rs:58-73), pick the downscale from
    #: MOTION_LADDER each frame so the moving-frame time tracks
    #: ``motion_target_ms``. Off by default (reference parity). Scales are
    #: quantized to the ladder so at most len(MOTION_LADDER) kernel shapes
    #: ever compile.
    adaptive_motion: bool = False
    motion_target_ms: int = 33

    def update(self, is_moving: bool) -> tuple["RenderParams", bool]:
        """Advance the frame counter (app.rs:43-57). Returns
        ``(new_params, accumulation_was_reset)``."""
        if is_moving or not self.accumulate:
            return dataclasses.replace(self, frames=-1), True
        return dataclasses.replace(self, frames=self.frames + 1), False

    def reset_frame(self) -> "RenderParams":
        return dataclasses.replace(self, frames=-1)

    def for_render(self, is_moving: bool,
                   motion_scale: int = 2) -> "RenderParams":
        """Motion degradation (app.rs:58-73): while the camera moves, drop to
        1/``motion_scale`` of the CURRENT resolution (min-clamped so tiny
        sessions stay renderable), 1 bounce, 1 ray/pixel for interactivity.
        The reference always halves (relative to the session size, not the
        1080p constant); ``motion_scale`` > 2 comes from the adaptive ladder
        (pick_motion_scale) when ``adaptive_motion`` is on."""
        if not is_moving:
            return self
        scale = max(int(motion_scale), 2)
        return dataclasses.replace(
            self,
            bounces=1,
            rays_per_pixel=1,
            width=max(self.width // scale, 16),
            height=max(self.height // scale, 16),
        )


#: Allowed moving-frame downscales for adaptive motion degradation. A small
#: fixed ladder bounds the number of distinct (W, H) kernel shapes XLA ever
#: compiles (static shapes: each scale is its own executable).
MOTION_LADDER = (2, 3, 4, 6, 8)


def pick_motion_scale(last_scale: int, last_render_s: float | None,
                      target_s: float) -> int:
    """Choose the moving-frame downscale from MOTION_LADDER.

    Prediction model: render time is pixel-bound at 1 bounce, so the time at
    scale ``s`` extrapolates from the last measured moving frame as
    ``last_render_s * (last_scale / s)**2``. Picks the finest scale whose
    predicted time fits ``target_s``; refinement (stepping to a finer scale
    than last time) additionally requires 20% headroom so borderline frames
    don't oscillate between two shapes (and two cached executables).
    """
    if last_render_s is None or last_render_s <= 0.0:
        return last_scale if last_scale in MOTION_LADDER else MOTION_LADDER[0]
    best = MOTION_LADDER[-1]
    for s in MOTION_LADDER:
        if last_render_s * (last_scale / s) ** 2 <= target_s:
            best = s
            break
    if best < last_scale \
            and last_render_s * (last_scale / best) ** 2 > 0.8 * target_s:
        best = last_scale
    return best

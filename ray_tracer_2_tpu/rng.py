"""Counter-hash RNG — bit-exact vectorized port of the reference's PRNG.

The reference kernel threads a mutable u32 seed per pixel through every random
draw (ray_tracer.wgsl:164-206): an LCG step followed by a PCG-style output
permutation. Reproducing the exact stream (seeded as
``pixel_index + abs(frames) * 719393``, ray_tracer.wgsl:475) lets fidelity
tests compare our renders against a trusted scalar oracle draw-for-draw, and
keeps every pixel's stream independent — the property that makes pixel-tile
sharding across devices collective-free.

All functions are shape-polymorphic: ``seed`` is a uint32 array of any shape,
and every draw returns ``(value, new_seed)`` in functional style (JAX has no
mutable state).
"""
from __future__ import annotations

import jax.numpy as jnp

_PI = 3.1415926  # the kernel's 7-digit pi (ray_tracer.wgsl:182,203,249)


def seed_for_pixel(pixel_index, frames):
    """``u32(y * width + x) + u32(abs(frames)) * 719393`` (ray_tracer.wgsl:475)."""
    f = jnp.abs(jnp.asarray(frames)).astype(jnp.uint32)
    return pixel_index.astype(jnp.uint32) + f * jnp.uint32(719393)


def next_u32(seed):
    """LCG advance + PCG output permutation (ray_tracer.wgsl:195-200)."""
    seed = seed * jnp.uint32(747796405) + jnp.uint32(2891336453)
    word = ((seed >> ((seed >> jnp.uint32(28)) + jnp.uint32(4))) ^ seed) * jnp.uint32(277803737)
    return (word >> jnp.uint32(22)) ^ word, seed


def rand(seed):
    """Uniform in [0, 1]: u32 / (2^32 - 1) (ray_tracer.wgsl:164-166)."""
    bits, seed = next_u32(seed)
    return bits.astype(jnp.float32) / jnp.float32(4294967295.0), seed


def rand_normal(seed):
    """Box–Muller (cos branch) (ray_tracer.wgsl:181-185).

    The reference computes ``log(rand())`` unguarded; a draw of exactly 0
    (expected every ~2^32 draws — a handful per converged 1080p frame) makes
    it -inf and poisons the pixel with NaN forever. We clamp the draw to the
    smallest positive value instead — same distribution, no NaN.
    """
    u1, seed = rand(seed)
    u2, seed = rand(seed)
    theta = 2.0 * _PI * u1
    rho = jnp.sqrt(-2.0 * jnp.log(jnp.maximum(u2, jnp.float32(2.33e-10))))
    return rho * jnp.cos(theta), seed


def rand_direction(seed):
    """Uniform direction: normalize of 3 gaussians (ray_tracer.wgsl:168-174).

    Draw order (x, y, z) matches the reference for stream parity.
    """
    x, seed = rand_normal(seed)
    y, seed = rand_normal(seed)
    z, seed = rand_normal(seed)
    v = jnp.stack([x, y, z], axis=-1)
    return v / jnp.sqrt(jnp.sum(v * v, axis=-1, keepdims=True)), seed


def rand_hemisphere(normal, seed):
    """Direction in the hemisphere of ``normal`` via sign flip
    (ray_tracer.wgsl:176-179).

    The reference multiplies by ``sign(dot)``, which is 0 when the draw is
    exactly perpendicular (a few times per converged 1080p frame in f32) and
    zeroes the direction → NaN after normalize. We flip with >= 0 instead.
    """
    d, seed = rand_direction(seed)
    flip = jnp.sum(normal * d, axis=-1, keepdims=True) >= 0.0
    return jnp.where(flip, d, -d), seed


def rand_in_unit_disk(seed):
    """Polar disk sample (ray_tracer.wgsl:202-206). Returns (..., 2)."""
    u1, seed = rand(seed)
    angle = u1 * 2.0 * _PI
    r2, seed = rand(seed)
    p = jnp.stack([jnp.cos(angle), jnp.sin(angle)], axis=-1)
    return p * jnp.sqrt(r2)[..., None], seed

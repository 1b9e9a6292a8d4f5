"""Small-vector math on trailing-axis-3 jnp arrays.

The reference uses glam ``Vec3``/``Mat4`` host-side and WGSL builtins
device-side. Here every helper is shape-polymorphic over leading batch axes so
the same code path serves one ray or a million: SoA ``(..., 3)`` float32
arrays, fully traceable under ``jit``/``vmap``/``shard_map``.
"""
from __future__ import annotations


import jax.numpy as jnp


def dot(a, b, keepdims: bool = False):
    # An unrolled elementwise variant was deleted: not bit-stable (FMA
    # contraction inside elementwise fusions moved the balls golden RMSE
    # 1.8e-3).
    return jnp.sum(a * b, axis=-1, keepdims=keepdims)


def length(v, keepdims: bool = False):
    return jnp.sqrt(dot(v, v, keepdims=keepdims))


def normalize(v, eps: float = 0.0):
    """Normalize along the last axis. Matches WGSL ``normalize`` (no eps guard)
    unless ``eps`` is given."""
    n = length(v, keepdims=True)
    if eps:
        n = jnp.maximum(n, eps)
    return v / n


def cross(a, b):
    return jnp.cross(a, b)


def reflect(i, n):
    """WGSL ``reflect``: i - 2*dot(i,n)*n."""
    return i - 2.0 * dot(i, n, keepdims=True) * n


def refract(i, n, eta):
    """WGSL ``refract(i, n, eta)``.

    Returns the refracted direction, or the zero vector on total internal
    reflection — byte-for-byte the WGSL semantics relied on by the glass
    branch of the reference kernel (ray_tracer.wgsl:423).

    ``eta`` broadcasts against the leading axes of ``i``/``n``.
    """
    eta = jnp.asarray(eta)[..., None] if jnp.ndim(eta) == jnp.ndim(i) - 1 else eta
    cos_i = dot(n, i, keepdims=True)
    k = 1.0 - eta * eta * (1.0 - cos_i * cos_i)
    refr = eta * i - (eta * cos_i + jnp.sqrt(jnp.maximum(k, 0.0))) * n
    return jnp.where(k < 0.0, jnp.zeros_like(i), refr)


def lerp(a, b, t):
    """WGSL ``mix``."""
    return a + (b - a) * t


def smoothstep(edge0, edge1, x):
    """WGSL ``smoothstep`` (clamped Hermite)."""
    t = jnp.clip((x - edge0) / (edge1 - edge0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)

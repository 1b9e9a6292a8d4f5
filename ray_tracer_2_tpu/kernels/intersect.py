"""Ray–primitive intersection math (ref: ray_tracer.wgsl:223-351).

Every function is batched over rays (leading axis B) and written branch-free:
vector lanes execute in lockstep, so "no hit" is a masked lane, not a
branch. Distances use the reference's INF sentinel (2^127) and epsilons so
behavior matches the WGSL kernel decision-for-decision.
"""
from __future__ import annotations

import jax.numpy as jnp

from ray_tracer_2_tpu.math.vec import cross, dot

INF = jnp.float32(1.7014118e38)   # 0x1p+127 (ray_tracer.wgsl:132)
EPSILON = jnp.float32(1e-5)       # ray_tracer.wgsl:131

#: dense sphere passes (XLA megakernel prepass AND the Pallas whole-path
#: kernel) switch to the shared-term restructure (ray_sphere_fast math) at
#: this sphere count; below it the exact reference-order quadratic keeps
#: small-scene goldens / cross-impl segment counts bit-stable.
#: RT2_SPHERE_FAST=0 forces the exact path everywhere, =1 forces fast.
SPHERE_FAST_MIN = 64


def sphere_fast_min() -> int:
    import os
    v = os.environ.get("RT2_SPHERE_FAST", "")
    if v == "0":
        return 1 << 30
    if v == "1":
        return 0
    return SPHERE_FAST_MIN


def ray_sphere(origin, direction, centre, radius):
    """Quadratic sphere test (ray_tracer.wgsl:223-256).

    origin/direction: (B, 3); centre: (..., 3), radius broadcastable — shapes
    broadcast to (B, S) when centre is (S, 3) and origin is (B, 1, 3).

    Returns (hit, dst, is_inside): normal/uv are derived by the caller for the
    winning sphere only.
    """
    oc = origin - centre
    a = dot(direction, direction)
    b = 2.0 * dot(oc, direction)
    c = dot(oc, oc) - radius * radius
    disc = b * b - 4.0 * a * c
    s = jnp.sqrt(jnp.maximum(disc, 0.0))
    dst_near = jnp.maximum(0.0, (-b - s) / (2.0 * a))
    dst_far = (-b + s) / (2.0 * a)
    is_inside = dst_near == 0.0
    hit = (disc >= 0.0) & (dst_far >= 0.001)
    dst = jnp.where(is_inside, dst_far, dst_near)
    return hit, jnp.where(hit, dst, INF), is_inside


def ray_sphere_fast(origin, direction, centre, radius, ck=None):
    """Dense (B, S) sphere cross with shared-term math — same decisions as
    :func:`ray_sphere` (ray_tracer.wgsl:223-256) but restructured for
    vector units: no (B, S, 3) intermediates, no (B, S) divides.

    Identities (h = -oc·d is b/-2, disc4 = disc/4, sq2 = s/2):
      oc·d  = o·d - c_i·d          (two rank-1 broadcasts, 5 ops each)
      |oc|² = |o|² - 2 o·c_i + K_i with K_i = |c_i|² - r_i² precomputed
      dst   = (-oc·d ∓ sq2) / a    with 1/a hoisted to (B,) — one divide
                                   per ray instead of two per (ray, sphere)

    NOT bit-identical to ray_sphere: the expanded |oc|² reassociates, so
    grazing hits can flip by ulps (same class of divergence as the sphere
    BVH — gated by pixel-match tests, tests/test_sphere_fast.py). Engaged
    above SPHERE_FAST_MIN spheres (kernels/megakernel.py).

    origin/direction: (B, 3); centre: (S, 3); radius: (S,); ck: optional
    precomputed K_i. Returns ((B, S) hit, dst, is_inside).
    """
    if ck is None:
        ck = dot(centre, centre) - radius * radius           # (S,)
    a = dot(direction, direction)                            # (B,)
    od = dot(origin, direction)                              # (B,)
    oo = dot(origin, origin)                                 # (B,)
    cd = (direction[:, 0:1] * centre[None, :, 0]
          + direction[:, 1:2] * centre[None, :, 1]
          + direction[:, 2:3] * centre[None, :, 2])          # (B, S)
    co = (origin[:, 0:1] * centre[None, :, 0]
          + origin[:, 1:2] * centre[None, :, 1]
          + origin[:, 2:3] * centre[None, :, 2])             # (B, S)
    h = od[:, None] - cd                                     # oc·d
    c = oo[:, None] - 2.0 * co + ck[None, :]                 # |oc|² - r²
    disc4 = h * h - a[:, None] * c
    sq2 = jnp.sqrt(jnp.maximum(disc4, 0.0))
    inv_a = 1.0 / a
    dst_near = jnp.maximum(0.0, (-h - sq2) * inv_a[:, None])
    dst_far = (-h + sq2) * inv_a[:, None]
    is_inside = dst_near == 0.0
    hit = (disc4 >= 0.0) & (dst_far >= 0.001)
    dst = jnp.where(is_inside, dst_far, dst_near)
    return hit, jnp.where(hit, dst, INF), is_inside


def sphere_normal_uv(hit_point, centre, is_inside):
    """Outward (or flipped-inside) normal + spherical UV
    (ray_tracer.wgsl:246-251)."""
    n = hit_point - centre
    n = n / jnp.sqrt(dot(n, n, keepdims=True))
    n = jnp.where(is_inside[..., None], -n, n)
    pi = jnp.float32(3.1415926)
    theta = jnp.arccos(jnp.clip(-n[..., 1], -1.0, 1.0))
    phi = jnp.arctan2(-n[..., 2], -n[..., 0]) + pi
    uv = jnp.stack([phi / (2.0 * pi), theta / pi], axis=-1)
    return n, uv


def ray_triangle(origin, direction, v0, v1, v2, cull_backface):
    """Möller–Trumbore (ray_tracer.wgsl:258-290), batched over any broadcast
    of rays × triangles.

    Returns (hit, dst, u, v, det): barycentrics (u toward v1, v toward v2,
    w = 1-u-v toward v0) and the determinant whose sign flags backfaces.
    """
    edge_ab = v1 - v0
    edge_ac = v2 - v0
    normal = cross(edge_ab, edge_ac)
    ao = origin - v0
    dao = cross(ao, direction)
    det = -dot(direction, normal)

    keep = jnp.where(cull_backface, det >= 1e-8, jnp.abs(det) >= 1e-8)
    inv_det = 1.0 / jnp.where(keep, det, 1.0)

    dst = dot(ao, normal) * inv_det
    u = dot(edge_ac, dao) * inv_det
    v = -dot(edge_ab, dao) * inv_det
    w = 1.0 - u - v
    hit = keep & (dst > EPSILON) & (u >= 0.0) & (v >= 0.0) & (w >= 0.0)
    return hit, jnp.where(hit, dst, INF), u, v, det


def ray_aabb_dist(origin, inv_dir, bmin, bmax, t_limit):
    """Slab test returning entry distance or INF (ray_tracer.wgsl:337-351)."""
    t1 = (bmin - origin) * inv_dir
    t2 = (bmax - origin) * inv_dir
    tmin = jnp.minimum(t1, t2)
    tmax = jnp.maximum(t1, t2)
    t_near = jnp.max(tmin, axis=-1)
    t_far = jnp.min(tmax, axis=-1)
    did_hit = (t_far >= t_near) & (t_near < t_limit) & (t_far > 0.0)
    return jnp.where(did_hit, t_near, INF)

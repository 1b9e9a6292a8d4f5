"""Brute-force broadcast intersection for small instance groups.

For small instance groups it is cheaper to stream EVERY triangle against
EVERY ray — a (B, T) broadcast with no dependent gathers — than to chase
BVH pointers. The reference does the analogous thing for spheres (linear
loop per ray, ray_tracer.wgsl:357-364); we extend it to small meshes.

Cornell Box (32 tris), the quad-built Room scenes, and the area lights all
take this path; big meshes (dragon, sponza) use kernels/traverse.py.
"""
from __future__ import annotations


import jax.numpy as jnp

from ray_tracer_2_tpu.kernels.intersect import INF, ray_triangle
from ray_tracer_2_tpu.scene.render_scene import RenderScene

#: instance groups at or below this triangle count stream (dense cross)
#: instead of traversing their wide BVH. Images are bit-equal across the
#: switch. The crossover was chosen before the H100 port and is queued for
#: an H100 A/B (ROADMAP D2).
BRUTE_MAX_TRIS = 256


def brute_max() -> int:
    """The brute-vs-BVH instance threshold; RT2_BRUTE_MAX_TRIS overrides
    for crossover A/Bs on the card (callers must clear jit caches after a flip
    — the threshold shapes the traced program but is not a jit key)."""
    import os
    return int(os.environ.get("RT2_BRUTE_MAX_TRIS", BRUTE_MAX_TRIS))


def brute_force_intersect(scene: RenderScene, origin, direction,
                          tri_offset: int, tri_count: int,
                          chunk: int = 512):
    """Closest hit over triangles [tri_offset, tri_offset+tri_count) for a
    batch of model-space rays — all data streams as broadcast constants.

    Returns the same record dict as traverse_bvh_packed (stats count every
    streamed triangle as tested).
    """
    B = origin.shape[0]
    best = dict(
        dst=jnp.full((B,), INF),
        tri=jnp.full((B,), -1, jnp.int32),
        u=jnp.zeros((B,)), v=jnp.zeros((B,)),
        det=jnp.zeros((B,)),
        mat=jnp.zeros((B,), jnp.int32),
    )
    o = origin[:, None, :]
    d = direction[:, None, :]
    for start in range(tri_offset, tri_offset + tri_count, chunk):
        end = min(start + chunk, tri_offset + tri_count)
        v0 = scene.tri_v0[start:end][None]
        v1 = scene.tri_v1[start:end][None]
        v2 = scene.tri_v2[start:end][None]
        mat = scene.tri_mat[start:end]
        cull = (jnp.take(scene.materials.flag, mat) != 1)[None, :]
        hit, dst, u, v, det = ray_triangle(o, d, v0, v1, v2, cull)
        k = jnp.argmin(dst, axis=1)
        # winner extraction via one-hot select + sum (exact: one nonzero
        # term), NOT take_along_axis — chosen before the H100 port, where a
        # per-lane scalar gather was far slower than the (B, T) one-hot
        # arithmetic; queued for an H100 A/B (ROADMAP S5). Same pattern as
        # the sphere prepass (megakernel.py segment_prepass).
        is_win = jnp.arange(v0.shape[1], dtype=jnp.int32)[None, :] \
            == k[:, None]
        dstk = jnp.sum(jnp.where(is_win, dst, 0.0), axis=1)
        better = dstk < best["dst"]

        def pick(m):
            return jnp.sum(jnp.where(is_win, m, 0.0), axis=1)

        best = dict(
            dst=jnp.where(better, dstk, best["dst"]),
            tri=jnp.where(better, start + k.astype(jnp.int32), best["tri"]),
            u=jnp.where(better, pick(u), best["u"]),
            v=jnp.where(better, pick(v), best["v"]),
            det=jnp.where(better, pick(det), best["det"]),
            mat=jnp.where(better,
                          jnp.sum(jnp.where(is_win, mat[None, :], 0),
                                  axis=1), best["mat"]),
        )
    stats = jnp.zeros((B, 2), jnp.int32).at[:, 1].set(tri_count)
    return dict(**best, stats=stats)

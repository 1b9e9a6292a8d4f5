"""Vectorized BVH traversal — a re-design of ray_tracer.wgsl:292-335.

The reference walks the tree with one stack per SIMT thread. Here a whole
**batch of rays walks in lockstep** as vector ops, and per-ray stacks (a
(B, depth) array plus scatters every push) are poison for that. The default traversal is therefore **stackless**: the scene carries
8 precomputed octant threadings (accel/threading.py) and each ray carries a
single node index. One loop step = one node gather + one AABB slab test +
either a fixed-width leaf chunk or a link follow. Near-first ordering (the
reference's child-distance compare, ray_tracer.wgsl:323-331) is preserved by
the octant ordering, and closest-hit pruning is *stronger* than the
reference's: the AABB test always uses the ray's current best distance,
whereas the stack version tests with the best at push time.

``traverse_bvh_stack`` keeps the literal per-ray-stack formulation for A/B
testing and as documentation of the reference contract.

Traversal stats: stats[0] counts AABB tests (node visits), stats[1] counts
triangle tests — same meaning as the reference's debug heatmap counters
(ray_tracer.wgsl:307,322), with slightly different absolute scale (the
reference counts both children per pop; the threaded walk tests one box per
visit).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ray_tracer_2_tpu.kernels.intersect import INF, ray_aabb_dist, ray_triangle
from ray_tracer_2_tpu.scene.render_scene import LEAF_CHUNK, RenderScene

# The reference uses a 32-entry stack (ray_tracer.wgsl:297) for max depth 32;
# forced median splits can go deeper, so the A/B stack version pads.
STACK_DEPTH = 72


def _leaf_chunk(scene, origin, direction, tri_base, count, valid_leaf,
                best_dst, best_tri, best_u, best_v, best_det=None,
                best_mat=None):
    """Intersect a <=LEAF_CHUNK-wide triangle slab, masked. ``best_det`` /
    ``best_mat`` are tracked when given (the debug/tiled path needs the
    winner's determinant sign and material id)."""
    for j in range(LEAF_CHUNK):
        tri_idx = tri_base + j
        valid = valid_leaf & (j < count)
        safe_idx = jnp.where(valid, tri_idx, 0)
        v0 = jnp.take(scene.tri_v0, safe_idx, axis=0)
        v1 = jnp.take(scene.tri_v1, safe_idx, axis=0)
        v2 = jnp.take(scene.tri_v2, safe_idx, axis=0)
        mat = jnp.take(scene.tri_mat, safe_idx)
        cull = jnp.take(scene.materials.flag, mat) != 1  # != GLASS
        hit, dst, u, v, det = ray_triangle(origin, direction, v0, v1, v2, cull)
        better = valid & hit & (dst < best_dst)
        best_tri = jnp.where(better, safe_idx, best_tri)
        best_u = jnp.where(better, u, best_u)
        best_v = jnp.where(better, v, best_v)
        best_dst = jnp.where(better, dst, best_dst)
        if best_det is not None:
            best_det = jnp.where(better, det, best_det)
            best_mat = jnp.where(better, mat, best_mat)
    return best_dst, best_tri, best_u, best_v, best_det, best_mat


def traverse_bvh(scene: RenderScene, origin, direction, inv_dir,
                 node_offset, tri_offset, cull_backface=None):
    """Stackless threaded closest-hit traversal for a batch of model-space
    rays, gathering from the UNPACKED binary node/link/triangle arrays.
    Used by the deterministic debug/tiled path only — the lit path runs the
    wide-row megakernel (kernels/megakernel.py), so this no longer needs
    the 8-octant packed-row table that once multiplied sponza-scale HBM
    residency several-fold. Returns dict with dst (B,), tri (B,) global
    triangle index (-1 = miss), u/v barycentrics, det, mat, stats (B, 2)."""
    B = origin.shape[0]
    n_nodes = scene.node_count.shape[0]

    octant = ((direction[:, 0] < 0).astype(jnp.int32)
              + 2 * (direction[:, 1] < 0).astype(jnp.int32)
              + 4 * (direction[:, 2] < 0).astype(jnp.int32))
    link_base = octant * n_nodes
    link_hit = scene.link_hit.reshape(-1)
    link_miss = scene.link_miss.reshape(-1)

    init = dict(
        cur=jnp.zeros((B,), jnp.int32) + node_offset,
        best_dst=jnp.full((B,), INF),
        best_tri=jnp.full((B,), -1, jnp.int32),
        best_u=jnp.zeros((B,)), best_v=jnp.zeros((B,)),
        best_det=jnp.zeros((B,)),
        best_mat=jnp.zeros((B,), jnp.int32),
        stats=jnp.zeros((B, 2), jnp.int32),
    )

    def cond(s):
        return jnp.any(s["cur"] >= 0)

    def body(s):
        cur = s["cur"]
        active = cur >= 0
        safe = jnp.where(active, cur, node_offset)

        bmin = jnp.take(scene.node_min, safe, axis=0)
        bmax = jnp.take(scene.node_max, safe, axis=0)
        count = jnp.take(scene.node_count, safe)
        first = jnp.take(scene.node_first, safe)

        d = ray_aabb_dist(origin, inv_dir, bmin, bmax, s["best_dst"])
        box_hit = active & (d < INF)
        is_leaf = count > 0

        best_dst, best_tri, best_u, best_v, best_det, best_mat = _leaf_chunk(
            scene, origin, direction, tri_offset + first, count,
            box_hit & is_leaf, s["best_dst"], s["best_tri"],
            s["best_u"], s["best_v"], s["best_det"], s["best_mat"])

        lh = jnp.take(link_hit, link_base + safe)
        lm = jnp.take(link_miss, link_base + safe)
        nxt = jnp.where(box_hit & ~is_leaf, lh, lm)

        stats = s["stats"]
        stats = stats.at[:, 0].add(active.astype(jnp.int32))
        stats = stats.at[:, 1].add(
            jnp.where(box_hit & is_leaf, count, 0))

        return dict(cur=jnp.where(active, nxt, cur), best_dst=best_dst,
                    best_tri=best_tri, best_u=best_u, best_v=best_v,
                    best_det=best_det, best_mat=best_mat, stats=stats)

    out = jax.lax.while_loop(cond, body, init)
    return dict(dst=out["best_dst"], tri=out["best_tri"],
                u=out["best_u"], v=out["best_v"], det=out["best_det"],
                mat=out["best_mat"], stats=out["stats"])


def traverse_bvh_stack(scene: RenderScene, origin, direction, inv_dir,
                       node_offset, tri_offset, cull_backface=None):
    """Per-ray-stack traversal — the literal vectorization of the reference's
    ray_BVH (ray_tracer.wgsl:292-335). Kept for A/B testing."""
    B = origin.shape[0]
    arange_b = jnp.arange(B)

    stack = jnp.zeros((B, STACK_DEPTH), jnp.int32)
    stack = stack.at[:, 0].set(node_offset)
    sp = jnp.ones((B,), jnp.int32)

    init = dict(
        stack=stack, sp=sp,
        best_dst=jnp.full((B,), INF),
        best_tri=jnp.full((B,), -1, jnp.int32),
        best_u=jnp.zeros((B,)), best_v=jnp.zeros((B,)),
        stats=jnp.zeros((B, 2), jnp.int32),
    )

    def cond(s):
        return jnp.any(s["sp"] > 0)

    def body(s):
        active = s["sp"] > 0
        pos = jnp.maximum(s["sp"] - 1, 0)
        node_idx = jnp.take_along_axis(s["stack"], pos[:, None], axis=1)[:, 0]
        sp = jnp.where(active, s["sp"] - 1, s["sp"])

        count = jnp.take(scene.node_count, node_idx)
        first = jnp.take(scene.node_first, node_idx)
        left = jnp.take(scene.node_left, node_idx)
        right = jnp.take(scene.node_right, node_idx)
        is_leaf = active & (count > 0)
        is_internal = active & (count == 0)

        best_dst, best_tri, best_u, best_v, _, _ = _leaf_chunk(
            scene, origin, direction, tri_offset + first, count, is_leaf,
            s["best_dst"], s["best_tri"], s["best_u"], s["best_v"])

        li = node_offset + left
        ri = node_offset + right
        safe_li = jnp.where(is_internal, li, 0)
        safe_ri = jnp.where(is_internal, ri, 0)
        a_min = jnp.take(scene.node_min, safe_li, axis=0)
        a_max = jnp.take(scene.node_max, safe_li, axis=0)
        b_min = jnp.take(scene.node_min, safe_ri, axis=0)
        b_max = jnp.take(scene.node_max, safe_ri, axis=0)
        dst_a = ray_aabb_dist(origin, inv_dir, a_min, a_max, best_dst)
        dst_b = ray_aabb_dist(origin, inv_dir, b_min, b_max, best_dst)

        left_closer = dst_a < dst_b
        near_dst = jnp.where(left_closer, dst_a, dst_b)
        far_dst = jnp.where(left_closer, dst_b, dst_a)
        near_idx = jnp.where(left_closer, safe_li, safe_ri)
        far_idx = jnp.where(left_closer, safe_ri, safe_li)

        stk = s["stack"]
        push_far = is_internal & (far_dst < best_dst)
        curv = jnp.take_along_axis(stk, sp[:, None], axis=1)[:, 0]
        stk = stk.at[arange_b, sp].set(jnp.where(push_far, far_idx, curv))
        sp = sp + push_far.astype(jnp.int32)

        push_near = is_internal & (near_dst < best_dst)
        curv = jnp.take_along_axis(stk, sp[:, None], axis=1)[:, 0]
        stk = stk.at[arange_b, sp].set(jnp.where(push_near, near_idx, curv))
        sp = sp + push_near.astype(jnp.int32)

        stats = s["stats"]
        stats = stats.at[:, 0].add(jnp.where(is_internal, 2, 0))
        stats = stats.at[:, 1].add(jnp.where(is_leaf, count, 0))

        return dict(stack=stk, sp=sp, best_dst=best_dst, best_tri=best_tri,
                    best_u=best_u, best_v=best_v, stats=stats)

    out = jax.lax.while_loop(cond, body, init)
    return dict(dst=out["best_dst"], tri=out["best_tri"],
                u=out["best_u"], v=out["best_v"], stats=out["stats"])

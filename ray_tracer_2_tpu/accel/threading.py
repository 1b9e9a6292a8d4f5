"""Octant-ordered skip-link ("threaded") BVH layout.

The reference traverses with a per-thread stack, pushing the near child last
so it pops first (ray_tracer.wgsl:323-331). Lockstep vector lanes pay dearly for
per-ray stacks (a (B, depth) array plus a scatter per push). Instead we
precompute, for each of the 8 ray-direction octants, a *threading* of the
tree: every node stores

  hit_next[o, n]  — where to go when this node's AABB is hit and it is
                    internal: its near child for octant ``o`` (the child on
                    the ray-approach side of the node's split axis);
  miss_next[o, n] — where to go when the AABB is missed, or after a leaf is
                    processed: the next unvisited subtree in octant-``o``
                    depth-first order (-1 terminates).

Traversal then carries ONE int per ray and does one node gather per step —
no stack, no scatters — while preserving near-first ordering (the same
heuristic the reference's child-distance compare realizes) and closest-hit
pruning (the AABB test uses the ray's current best distance).

Links are computed level-by-level with vectorized numpy: children always have
larger indices than parents (builder appends), and ``miss_next[child]``
depends only on the parent's links.
"""
from __future__ import annotations

import numpy as np

from ray_tracer_2_tpu.accel.bvh import BVH


def compute_skip_links(bvh: BVH) -> tuple[np.ndarray, np.ndarray]:
    """Returns (hit_next, miss_next), each (8, N) int32 with local node
    indices and -1 as the terminator."""
    n = bvh.n_nodes
    left, right = bvh.node_left, bvh.node_right
    internal = bvh.node_count == 0
    # A single-leaf tree (possible for tiny groups) has node 0 as leaf.
    if not internal.any():
        hit = np.full((8, n), -1, np.int32)
        return hit, hit.copy()

    axis = bvh.node_axis
    # Level sweep: collect the internal nodes of each depth (parents always
    # precede children, so a frontier walk terminates).
    cur = np.zeros(n, bool)
    cur[0] = True
    order_levels = []
    while cur.any():
        parents = cur & internal
        order_levels.append(np.flatnonzero(parents))
        nxt = np.zeros(n, bool)
        nxt[left[parents]] = True
        nxt[right[parents]] = True
        cur = nxt

    hit_next = np.full((8, n), -1, np.int32)
    miss_next = np.full((8, n), -1, np.int32)

    for o in range(8):
        sign = np.array([(o >> 0) & 1, (o >> 1) & 1, (o >> 2) & 1], bool)
        flip = sign[axis]  # ray dir negative along split axis ⇒ near = right
        near = np.where(flip, right, left).astype(np.int32)
        far = np.where(flip, left, right).astype(np.int32)
        hn = hit_next[o]
        mn = miss_next[o]
        mn[0] = -1
        for level_nodes in order_levels:
            if len(level_nodes) == 0:
                continue
            ln = level_nodes
            hn[ln] = near[ln]
            mn[near[ln]] = far[ln]
            mn[far[ln]] = mn[ln]
    return hit_next, miss_next

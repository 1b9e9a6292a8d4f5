"""COMPACT 32-ary (wide) BVH rows — one CANONICAL table, contiguous children.

Traversal is a chain of dependent row gathers, so FETCH COUNT is the
lever, and one canonical table stays smaller (more cache-resident) than
8 octant-ordered copies. Replayed on the real dragon BVH, a 16-ary
collapse with a per-lane (base, hitmask) resume stack needs ~11 row
fetches per segment vs 29-34 for the binary skip-link scheme
(scripts/sim_wide.py), and a 32-ary collapse cuts that to ~9
(scripts/sim_wide256.py) — but 32 f32 AABBs don't fit a 512-byte row.
The row width was chosen before the H100 port and is queued for an H100
A/B (ROADMAP D3).

So child AABBs are stored as CONSERVATIVELY-ROUNDED float16 pairs packed
into f32 columns: 32 children x 6 bounds = 192 f16 = 96 f32 columns, and
the row stays 128 f32 (512 B — the gather granularity floor). Outward f16
rounding only GROWS boxes, so traversal stays exact (pruning never loses
a true hit); the measured visit inflation on the dragon is < 1%
(scripts/sim_wide32c.py: 8.96 vs 8.95 exact).

The column order is COMPONENT-BLOCKED, not per-child: all 32 min_x values
first, then min_y, min_z (and the max in each column's high 16 bits).
This turns the kernel's slab test into ~15 WIDE (B, 32) vector ops
instead of 32 narrow (B, 3) slices.

Layout (one f32[128] row per node):

  wide row  (COL_COUNT == 0)
    12      base: first child row id (children CONTIGUOUS)
    13      k: child count (<= 32)
    16..112 children AABBs: 96 f32 cols; col 16 + 32*axis + c packs child
            c's (min[axis] in the LOW 16 bits, max[axis] in the HIGH 16
            bits) as f16. The kernel unpacks with integer shifts/masks
            and a native f16 -> f32 conversion; bounds are also
            pre-clamped away from the f16 denormal range, so no
            denormal-flushing path can shrink a box. Empty slots hold
            inverted boxes and are excluded by the c < k gate
  leaf row  (COL_COUNT > 0): identical to accel/packed.py leaf rows
    (COL_FIRST/COL_MATS/COL_CULLS/COL_TRIS) so the megakernel's leaf
    intersection code is shared between both traversals. Leaf triangle
    data stays EXACT f32 — only the pruning boxes are f16.

Near-first ordering is per-ray: the kernel enters the MINIMUM-DISTANCE
hit child; the resume stack stores (base child-row id, remaining hit
mask) and resumes at `base + ctz(mask)` — no parent re-fetch. Fetch
count is order-invariant for the mask-stack scheme, so resume order
costs nothing.

Reference contract: the traversal replaces the reference's per-ray stack
walk (ray_tracer.wgsl:292-335) with visit-identical closest-hit semantics.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ray_tracer_2_tpu.accel.bvh import BVH

from ray_tracer_2_tpu.accel.packed import COL_COUNT, COL_FIRST, ROW_TRIS

ROW_WIDTH = 128
COL_BASE = 12
COL_K = 13
COL_CHILD_AABB = 16   # wide rows only: 96 f32 cols of packed f16 pairs
N_AABB_COLS = 96
MAX_ARITY = 32

# Wide-path LEAF rows use a COMPONENT-BLOCKED geometry layout (this
# diverges from accel/packed.py's AoS leaf rows, which the binary
# debug/tiled path keeps): the megakernel's 8-triangle Möller–Trumbore
# runs as ~45 wide (B, 8) vector ops instead of 8 sequential passes of
# narrow (B, 3) slices. Edges and the geometric normal are precomputed
# at pack time with the same f32 arithmetic the kernel used, so results
# are unchanged.
#
#   cols 0..8    matcull[j] = tri_mat * 2 + cull   (decode: >>1, &1)
#   col  15/16   COL_COUNT / COL_FIRST (shared with packed.py)
#   cols 17..113 12 components x 8 tris, blocked:
#                v0x*8 v0y*8 v0z*8 e1x*8 e1y*8 e1z*8
#                e2x*8 e2y*8 e2z*8 nx*8  ny*8  nz*8
COL_MATCULL = 0
COL_LEAF_GEO = 17
N_LEAF_GEO_COLS = 96

# Sphere-BVH leaf rows (pack_sphere_wide_rows) reuse the same row shape:
#   cols 0..8    original sphere id (float, exact — ids < 2^24)
#   col  15/16   COL_COUNT / COL_FIRST (shared)
#   cols 17..49  4 components x 8 spheres, blocked: cx*8 cy*8 cz*8 r2*8
#                (empty slots carry r2 = -1: disc = b^2-4a(|oc|^2+1) < 0
#                by Cauchy-Schwarz, so they can never hit)
COL_SPH_ID = 0
SPH_CHUNK = 8


_F16_MIN_NORMAL = np.float16(2.0 ** -14)


def _round_out_f16(lo: np.ndarray, hi: np.ndarray):
    """Conservative outward rounding of box bounds to f16: lo rounds toward
    -inf, hi toward +inf, so boxes only grow (pruning stays exact).

    Denormal f16 results are pushed outward to the nearest of {0, ±2^-14}:
    a denormal-flushing decode would snap them toward zero — which for a
    NEGATIVE min (or positive max) would SHRINK the box. Clamping at pack
    time keeps every stored bound a normal number."""
    lo16 = lo.astype(np.float16)
    over = lo16.astype(np.float32) > lo
    lo16 = np.where(over, np.nextafter(lo16, np.float16(-np.inf)), lo16)
    den = (lo16 != 0) & (np.abs(lo16) < _F16_MIN_NORMAL)
    lo16 = np.where(den, np.where(lo16 > 0, np.float16(0), -_F16_MIN_NORMAL),
                    lo16)
    hi16 = hi.astype(np.float16)
    under = hi16.astype(np.float32) < hi
    hi16 = np.where(under, np.nextafter(hi16, np.float16(np.inf)), hi16)
    den = (hi16 != 0) & (np.abs(hi16) < _F16_MIN_NORMAL)
    hi16 = np.where(den, np.where(hi16 > 0, _F16_MIN_NORMAL, np.float16(0)),
                    hi16)
    return lo16.astype(np.float16), hi16.astype(np.float16)


def _pack_f16_pairs(vals: np.ndarray) -> np.ndarray:
    """(..., 2n) f16 -> (..., n) f32 with even indices in the LOW 16 bits
    (matches jax.lax.bitcast_convert_type(f32 -> f16)[..., 0])."""
    u16 = np.ascontiguousarray(vals).view(np.uint16)
    lo = u16[..., 0::2].astype(np.uint32)
    hi = u16[..., 1::2].astype(np.uint32) << 16
    return (lo | hi).view(np.float32)


def _unpack_f16_pairs(cols: np.ndarray) -> np.ndarray:
    """(..., n) f32 -> (..., 2n) f16 (inverse of _pack_f16_pairs)."""
    u32 = np.ascontiguousarray(cols).view(np.uint32)
    out = np.empty(cols.shape[:-1] + (cols.shape[-1] * 2,), np.uint16)
    out[..., 0::2] = (u32 & 0xFFFF).astype(np.uint16)
    out[..., 1::2] = (u32 >> 16).astype(np.uint16)
    return out.view(np.float16)


@dataclasses.dataclass
class WideBVH:
    """Collapse result: wide nodes referencing binary node ids."""

    children: list          # wide id -> list of binary node ids
    wide_of: dict           # binary internal node id -> wide id
    root_is_leaf: bool
    depth: int              # max wide-tree depth (stack bound)


def collapse(bvh: BVH, arity: int = MAX_ARITY) -> WideBVH:
    """Collapse the binary BVH into <=arity-ary wide nodes by repeatedly
    expanding the frontier's largest-subtree internal node."""
    left, right = bvh.node_left, bvh.node_right
    count = bvh.node_count
    n = bvh.n_nodes
    if n == 0 or count[0] > 0:
        return WideBVH([], {}, True, 1)

    tris = np.zeros(n, np.int64)
    stack = [(0, False)]
    while stack:
        nd, done = stack.pop()
        if done:
            tris[nd] = (count[nd] if count[nd]
                        else tris[left[nd]] + tris[right[nd]])
            continue
        stack.append((nd, True))
        if count[nd] == 0:
            stack.append((int(left[nd]), False))
            stack.append((int(right[nd]), False))

    children: list[list[int]] = []
    wide_of: dict[int, int] = {}
    depth = 1
    pending = [(0, 1)]
    while pending:
        root, d = pending.pop()
        depth = max(depth, d)
        frontier = [int(left[root]), int(right[root])]
        while len(frontier) < arity:
            internals = [c for c in frontier if count[c] == 0]
            if not internals:
                break
            big = max(internals, key=lambda c: tris[c])
            frontier.remove(big)
            frontier += [int(left[big]), int(right[big])]
        wid = len(children)
        children.append(frontier)
        wide_of[root] = wid
        for c in frontier:
            if count[c] == 0:
                pending.append((c, d + 1))
    return WideBVH(children, wide_of, False, depth)


def pack_wide_rows(bvh: BVH, v0, v1, v2, tri_mat, tri_cull,
                   row_offset: int, tri_offset: int):
    """Build the CANONICAL (R, 128) wide row table for one group BVH.

    One table, not eight octant copies: a smaller table stays
    cache-resident, which was measured (before the H100 port) to beat any
    near-first gain from per-octant child ordering. Near-first entry is
    preserved anyway: the kernel picks
    the MINIMUM-DISTANCE hit child per ray at each wide node; only resume
    order is positional, and resumed children are fetched either way (the
    fetch count is order-invariant for the mask-stack scheme).

    v0/v1/v2/tri_mat/tri_cull are LEAF-ORDERED triangle arrays (permuted by
    bvh.tri_order). Returns (rows (R, 128) f32, n_rows, wide_depth)."""
    count = bvh.node_count

    # ---- leaf row payloads, one per binary leaf: blocked geometry with
    # precomputed f32 edges + geometric normal (see layout above) --------
    def leaf_row(nd: int) -> np.ndarray:
        r = np.zeros(ROW_WIDTH, np.float32)
        first, k = int(bvh.node_first[nd]), int(count[nd])
        r[COL_COUNT] = k
        r[COL_FIRST] = first + tri_offset
        n_tris = len(v0)
        for j in range(ROW_TRIS):
            tri = min(first + j, max(n_tris - 1, 0))
            valid = j < k
            r[COL_MATCULL + j] = ((tri_mat[tri] * 2 + tri_cull[tri])
                                  if valid else 1.0)
            if valid:
                a = np.asarray(v0[tri], np.float32)
                e1 = (np.asarray(v1[tri], np.float32) - a).astype(np.float32)
                e2 = (np.asarray(v2[tri], np.float32) - a).astype(np.float32)
                # same component expressions as jnp.cross in f32
                n = np.array([e1[1] * e2[2] - e1[2] * e2[1],
                              e1[2] * e2[0] - e1[0] * e2[2],
                              e1[0] * e2[1] - e1[1] * e2[0]], np.float32)
                comps = np.concatenate([a, e1, e2, n])
                for ci in range(12):
                    r[COL_LEAF_GEO + 8 * ci + j] = comps[ci]
            # invalid slots: zero geometry -> n = 0 -> det = 0 -> the
            # keep-gate rejects them (matcull odd => cull => det >= 1e-8)
        return r

    return _pack_rows(bvh, leaf_row, row_offset)


def _pack_rows(bvh: BVH, leaf_row, row_offset: int):
    """Shared internal-row packer: collapse the binary BVH and lay out wide
    rows (BFS, children contiguous) calling ``leaf_row(node)`` for leaf
    payloads. Returns (rows, n_rows, depth)."""
    wb = collapse(bvh)
    count = bvh.node_count

    if wb.root_is_leaf:
        rows = np.zeros((1, ROW_WIDTH), np.float32)
        rows[0] = leaf_row(0)
        return rows, 1, 1

    n_rows = 1 + sum(len(c) for c in wb.children)
    rows = np.zeros((n_rows, ROW_WIDTH), np.float32)

    # BFS numbering: children of each wide node contiguous
    next_id = 1
    queue = [(wb.wide_of[0], 0)]  # (wide id, its row id)
    while queue:
        wid, rid = queue.pop(0)
        kids = wb.children[wid]
        base = next_id
        next_id += len(kids)
        r = rows[rid]
        r[COL_BASE] = base
        r[COL_K] = len(kids)
        r[COL_COUNT] = 0.0
        aab = np.empty((MAX_ARITY, 6), np.float32)
        # empty slots: inverted boxes never hit
        aab[:, 0:3] = np.inf
        aab[:, 3:6] = -np.inf
        for slot, c in enumerate(kids):
            aab[slot, 0:3] = bvh.node_min[c]
            aab[slot, 3:6] = bvh.node_max[c]
            crow = base + slot
            if count[c] > 0:
                rows[crow] = leaf_row(c)
            else:
                queue.append((wb.wide_of[c], crow))
        lo16, hi16 = _round_out_f16(aab[:, 0:3], aab[:, 3:6])
        # col 32*axis + c = (min[axis] of child c in low half, max in high)
        inter = np.empty((N_AABB_COLS, 2), np.float16)
        inter[:, 0] = lo16.T.reshape(-1)   # blocked: x*32 | y*32 | z*32
        inter[:, 1] = hi16.T.reshape(-1)
        r[COL_CHILD_AABB:COL_CHILD_AABB + N_AABB_COLS] = \
            _pack_f16_pairs(inter.reshape(-1))

    # globalize base ids
    rows[:, COL_BASE] += np.where(rows[:, COL_COUNT] == 0.0, row_offset, 0.0)
    return rows, n_rows, wb.depth


def pack_sphere_wide_rows(bvh: BVH, pos, radius, row_offset: int):
    """Wide-row table for a SPHERE BVH (world space). ``pos``/``radius`` are
    LEAF-ORDERED (permuted by bvh.tri_order); cols 0..8 carry the ORIGINAL
    sphere ids so the kernel can fetch centre/material for the winner.

    The reference has no sphere acceleration at all — its kernel loops every
    sphere per ray (ray_tracer.wgsl:357-364). Kept as a KNOB only
    (render_scene.SPHERE_BVH_MIN, RT2_SPHERE_BVH): before the H100 port
    it lost to the dense (B, S) cross on random_balls; queued for an H100
    A/B (ROADMAP D2). NOT bit-equal to the
    dense path: the blocked (B, 8) quadratic and the dense (B, S) quadratic
    compile to different FMA/re-association, and grazing hits (huge ground
    sphere, disc near 0) amplify the ulp differences — ~0.6% of
    random_balls pixels re-route (winner identity still matches the dense
    tie rule whenever distances agree exactly)."""
    order = bvh.tri_order
    orig_ids = np.asarray(order, np.float32)  # leaf slot -> original id
    n = len(pos)

    def leaf_row(nd: int) -> np.ndarray:
        r = np.zeros(ROW_WIDTH, np.float32)
        first, k = int(bvh.node_first[nd]), int(bvh.node_count[nd])
        r[COL_COUNT] = k
        r[COL_FIRST] = first
        for j in range(SPH_CHUNK):
            s = min(first + j, max(n - 1, 0))
            valid = j < k
            r[COL_SPH_ID + j] = orig_ids[s] if valid else 0.0
            c = np.asarray(pos[s], np.float32)
            rad = np.float32(radius[s])
            r[COL_LEAF_GEO + j] = c[0]
            r[COL_LEAF_GEO + 8 + j] = c[1]
            r[COL_LEAF_GEO + 16 + j] = c[2]
            # r2 precomputed with the same f32 multiply the dense path does;
            # empty slots get -1 (can never produce disc >= 0)
            r[COL_LEAF_GEO + 24 + j] = (rad * rad) if valid else -1.0
        return r

    return _pack_rows(bvh, leaf_row, row_offset)


def traverse_wide_numpy(rows_oct: np.ndarray, o, d, t_limit=np.inf,
                        depth: int = 16):
    """Scalar reference traversal for tests: closest hit through the
    canonical wide table (single group at row 0), entering the
    minimum-distance hit child first like the kernel. Returns (dst, tri,
    u, v, det, fetches)."""
    INF = np.float32(1.7014118e38)
    inv = 1.0 / np.where(np.abs(d) > 1e-30, d, 1e-30)
    best = np.float32(min(t_limit, INF))
    best_tri, best_u, best_v, best_det = -1, 0.0, 0.0, 0.0
    stack: list[tuple[int, int]] = []
    cur = 0
    fetches = 0
    while True:
        r = rows_oct[cur]
        fetches += 1
        k = int(r[COL_COUNT])
        descend = -1
        if k > 0:  # leaf (blocked geometry: v0, e1, e2, n precomputed)
            for j in range(k):
                g = r[COL_LEAF_GEO + j:COL_LEAF_GEO + 96:8]   # 12 comps
                v0, e1, e2, nrm = g[0:3], g[3:6], g[6:9], g[9:12]
                det = -np.dot(d, nrm)
                mc = int(r[COL_MATCULL + j])
                cull = (mc & 1) == 1
                if (det < 1e-8) if cull else (abs(det) < 1e-8):
                    continue
                ao = o - v0
                dao = np.cross(ao, d)
                dst = np.dot(ao, nrm) / det
                u = np.dot(e2, dao) / det
                v = -np.dot(e1, dao) / det
                if dst > 1e-5 and u >= 0 and v >= 0 and u + v <= 1 \
                        and dst < best:
                    best, best_tri = dst, int(r[COL_FIRST]) + j
                    best_u, best_v, best_det = u, v, det
        else:
            pairs = _unpack_f16_pairs(
                r[COL_CHILD_AABB:COL_CHILD_AABB + N_AABB_COLS]
            ).astype(np.float32).reshape(N_AABB_COLS, 2)
            lo = pairs[:, 0].reshape(3, MAX_ARITY).T   # (32, 3) mins
            hi = pairs[:, 1].reshape(3, MAX_ARITY).T
            aab = np.concatenate([lo, hi], axis=1)
            mask = 0
            dn_min, c_min = np.inf, -1
            for c in range(MAX_ARITY):
                t1 = (aab[c, 0:3] - o) * inv
                t2 = (aab[c, 3:6] - o) * inv
                tn = np.minimum(t1, t2).max()
                tf = np.maximum(t1, t2).min()
                if tf >= tn and tn < best and tf > 0 \
                        and c < int(r[COL_K]):
                    mask |= 1 << c
                    if tn < dn_min:
                        dn_min, c_min = tn, c
            if mask:
                base = int(r[COL_BASE])
                descend = base + c_min          # nearest hit child first
                rem = mask & ~(1 << c_min)
                if rem:
                    stack.append((base, rem))
        if descend >= 0:
            cur = descend
            continue
        # pop
        while stack:
            base, m = stack[-1]
            low = m & -m
            nxt = base + int(low - 1).bit_count()
            rem = m & (m - 1)
            if rem:
                stack[-1] = (base, rem)
            else:
                stack.pop()
            cur = nxt
            break
        else:
            return (best, best_tri, best_u, best_v, best_det, fetches)

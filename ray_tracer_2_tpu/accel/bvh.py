"""SAH BVH builder (ref: src/core/bvh.rs).

Same cost model and traversal contract as the reference — binary tree, root at
node 0, internal nodes store ``left``/``right`` child indices, leaves store a
``[first, first+count)`` triangle range, split accepted when
``SAH cost < half_area(parent) * count`` (bvh.rs:68-74,352-370), max depth 32
(bvh.rs:141) — but the splitter is a vectorized **binned** SAH over numpy
arrays instead of the reference's per-triangle sweep of <=50 candidate planes
per axis (bvh.rs:323-347): O(n) per node, no per-triangle Python loops, and
equivalent tree quality.

One deliberate extension for vectorized traversal: leaves are force-split down to
``max_leaf`` triangles (default 4) so the traversal kernel can intersect a
whole leaf as one fixed-width vector chunk. The reference's SIMT kernel loops
``node.count`` times per leaf (ray_tracer.wgsl:308-314); lockstep vector lanes
want a static chunk width instead.

If the C++ native builder extension is available (accel/native), it is used
automatically for large meshes; this module is the reference implementation
and the fallback.
"""
from __future__ import annotations

import dataclasses
import enum
import time

import numpy as np

MAX_DEPTH = 32          # bvh.rs:141
DEFAULT_MAX_LEAF = 4    # traversal chunk width
N_BINS = 32             # binned-SAH resolution (ref uses <=50 swept planes)


class BVHQuality(enum.Enum):
    LOW = "low"            # midpoint of longest axis (bvh.rs:314-322)
    HIGH = "high"          # binned SAH (bvh.rs:323-347)
    DISABLED = "disabled"  # single leaf (bvh.rs:270-273)


@dataclasses.dataclass
class BVHStats:
    """bvh.rs:474-530."""

    build_seconds: float = 0.0
    node_count: int = 0
    leaf_count: int = 0
    leaf_min_depth: int = 0
    leaf_max_depth: int = 0
    mean_depth: float = 0.0
    min_tris: int = 0
    max_tris: int = 0
    mean_tris: float = 0.0
    total_tris: int = 0


@dataclasses.dataclass
class BVH:
    """Flat SoA node arrays + the triangle permutation that sorts the caller's
    triangle soup into leaf order."""

    node_min: np.ndarray    # (N, 3) float32
    node_max: np.ndarray    # (N, 3) float32
    node_left: np.ndarray   # (N,) int32 — child index (local), internal only
    node_right: np.ndarray  # (N,) int32
    node_first: np.ndarray  # (N,) int32 — first triangle (local), leaf only
    node_count: np.ndarray  # (N,) int32 — 0 ⇒ internal
    node_axis: np.ndarray   # (N,) int32 — split axis (internal), 0 for leaves
    tri_order: np.ndarray   # (T,) int64 permutation of input triangles
    stats: BVHStats

    @property
    def n_nodes(self) -> int:
        return len(self.node_count)


def build_bvh(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray,
              quality: BVHQuality = BVHQuality.HIGH,
              max_leaf: int = DEFAULT_MAX_LEAF,
              use_native: bool | None = None) -> BVH:
    """Build over a triangle soup given as three (T, 3) vertex arrays.

    ``use_native``: force the C++ builder on/off; default tries native for
    meshes large enough to matter and falls back to numpy.
    """
    t_start = time.perf_counter()
    n = len(v0)

    if use_native is None:
        use_native = n >= 4096
    if use_native and n > 0:
        from ray_tracer_2_tpu.accel import native
        q = {BVHQuality.DISABLED: 0, BVHQuality.LOW: 1, BVHQuality.HIGH: 2}[quality]
        arrs = native.build_native(v0, v1, v2, max_leaf, q)
        if arrs is not None:
            stats = _stats_from_arrays(arrs, time.perf_counter() - t_start)
            return BVH(stats=stats, **arrs)
    if n == 0:
        z3 = np.zeros((1, 3), np.float32)
        zi = np.zeros(1, np.int32)
        return BVH(z3, z3, zi, zi.copy(), zi.copy(), zi.copy(), zi.copy(),
                   np.zeros(0, np.int64), BVHStats())

    tri_min = np.minimum(np.minimum(v0, v1), v2).astype(np.float32)
    tri_max = np.maximum(np.maximum(v0, v1), v2).astype(np.float32)
    centroid = ((v0 + v1 + v2) * (1.0 / 3.0)).astype(np.float32)
    return build_bvh_bounds(tri_min, tri_max, centroid, quality=quality,
                            max_leaf=max_leaf, t_start=t_start)


def build_bvh_bounds(tri_min: np.ndarray, tri_max: np.ndarray,
                     centroid: np.ndarray,
                     quality: BVHQuality = BVHQuality.HIGH,
                     max_leaf: int = DEFAULT_MAX_LEAF,
                     t_start: float | None = None) -> BVH:
    """Build over arbitrary primitive AABBs (e.g. spheres — the sphere
    acceleration structure reuses the triangle machinery wholesale; the
    reference has no sphere BVH at all, its kernel loops every sphere per
    ray, ray_tracer.wgsl:357-364). ``tri_order`` is the primitive
    permutation."""
    t_start = time.perf_counter() if t_start is None else t_start
    n = len(tri_min)
    if n == 0:
        z3 = np.zeros((1, 3), np.float32)
        zi = np.zeros(1, np.int32)
        return BVH(z3, z3, zi, zi.copy(), zi.copy(), zi.copy(), zi.copy(),
                   np.zeros(0, np.int64), BVHStats())

    order = np.arange(n, dtype=np.int64)

    node_min: list = [tri_min.min(axis=0)]
    node_max: list = [tri_max.max(axis=0)]
    node_left = [0]
    node_right = [0]
    node_first = [0]
    node_count = [n]
    node_axis = [0]

    stats = BVHStats()
    leaf_depths: list[int] = []
    leaf_tris: list[int] = []

    # Explicit stack of (node_idx, start, count, depth). Leaves are ALWAYS
    # forced down to <= max_leaf (the traversal kernel's fixed chunk width);
    # DISABLED quality means "no SAH" (median splits only), not "one giant
    # leaf" as in the reference (bvh.rs:270-273) — the vector kernel needs
    # the bound either way.
    stack = [(0, 0, n, 0)]
    hard_depth = 2 * MAX_DEPTH  # forced median splits may exceed SAH depth
    while stack:
        node_idx, start, count, depth = stack.pop()
        sel = order[start:start + count]
        bb_min, bb_max = node_min[node_idx], node_max[node_idx]
        parent_cost = _half_area(bb_min, bb_max) * count

        # Leaves are exactly one traversal chunk: splitting below max_leaf
        # buys nothing (the kernel intersects LEAF_CHUNK triangles per leaf
        # visit regardless) and triples node count/build time. The reference
        # splits while SAH says so, down to 1-triangle leaves (bvh.rs:391).
        if count <= max_leaf:
            leaf_depths.append(depth)
            leaf_tris.append(count)
            continue

        split = None
        if count > 1 and depth < MAX_DEPTH and quality is not BVHQuality.DISABLED:
            if quality is BVHQuality.HIGH:
                split = _best_binned_split(centroid[sel], tri_min[sel],
                                           tri_max[sel], bb_min, bb_max)
            else:
                split = _midpoint_split(centroid[sel], tri_min[sel],
                                        tri_max[sel], bb_min, bb_max)

        must_split = count > max_leaf and depth < hard_depth
        good_split = (split is not None and split[0] < parent_cost
                      and split[1].any() and not split[1].all())
        if good_split or must_split:
            if good_split:
                _, mask, axis, lmin, lmax, rmin, rmax = split
            else:
                # Median index split: always valid, keeps the tree balanced.
                mask = np.zeros(count, bool)
                mask[:count // 2] = True
                axis = int(np.argmax(bb_max - bb_min))
                lmin = tri_min[sel[mask]].min(axis=0)
                lmax = tri_max[sel[mask]].max(axis=0)
                rmin = tri_min[sel[~mask]].min(axis=0)
                rmax = tri_max[sel[~mask]].max(axis=0)
            # Partition the permutation in place (bvh.rs:400-411).
            order[start:start + count] = np.concatenate([sel[mask], sel[~mask]])
            left_count = int(mask.sum())

            left_idx = len(node_count)
            right_idx = left_idx + 1
            node_min.extend([lmin, rmin]); node_max.extend([lmax, rmax])
            node_left.extend([0, 0]); node_right.extend([0, 0])
            node_first.extend([start, start + left_count])
            node_count.extend([left_count, count - left_count])
            node_axis.extend([0, 0])
            node_left[node_idx] = left_idx
            node_right[node_idx] = right_idx
            node_count[node_idx] = 0
            node_axis[node_idx] = axis
            stack.append((left_idx, start, left_count, depth + 1))
            stack.append((right_idx, start + left_count, count - left_count, depth + 1))
        else:
            leaf_depths.append(depth)
            leaf_tris.append(count)

    stats.build_seconds = time.perf_counter() - t_start
    stats.node_count = len(node_count)
    stats.leaf_count = len(leaf_tris) if leaf_tris else 1
    if leaf_tris:
        stats.leaf_min_depth = int(min(leaf_depths))
        stats.leaf_max_depth = int(max(leaf_depths))
        stats.mean_depth = float(np.mean(leaf_depths))
        stats.min_tris = int(min(leaf_tris))
        stats.max_tris = int(max(leaf_tris))
        stats.mean_tris = float(np.mean(leaf_tris))
        stats.total_tris = int(sum(leaf_tris))
    else:
        stats.max_tris = stats.total_tris = n

    return BVH(
        node_min=np.asarray(node_min, np.float32),
        node_max=np.asarray(node_max, np.float32),
        node_left=np.asarray(node_left, np.int32),
        node_right=np.asarray(node_right, np.int32),
        node_first=np.asarray(node_first, np.int32),
        node_count=np.asarray(node_count, np.int32),
        node_axis=np.asarray(node_axis, np.int32),
        tri_order=order,
        stats=stats,
    )


def _stats_from_arrays(arrs: dict, build_seconds: float) -> BVHStats:
    """BVHStats (bvh.rs:474-530) recomputed from flat node arrays (the native
    builder doesn't track stats inline)."""
    count = arrs["node_count"]
    left = arrs["node_left"]
    right = arrs["node_right"]
    n = len(count)
    depth = np.zeros(n, np.int32)
    internal = count == 0
    # level sweep (parents precede children by construction)
    cur = np.zeros(n, bool)
    cur[0] = True
    d = 0
    while cur.any():
        parents = cur & internal
        nxt = np.zeros(n, bool)
        nxt[left[parents]] = True
        nxt[right[parents]] = True
        depth[left[parents]] = d + 1
        depth[right[parents]] = d + 1
        cur = nxt
        d += 1
    leaves = ~internal
    lt = count[leaves]
    ld = depth[leaves]
    return BVHStats(
        build_seconds=build_seconds,
        node_count=n,
        leaf_count=int(leaves.sum()),
        leaf_min_depth=int(ld.min()) if len(ld) else 0,
        leaf_max_depth=int(ld.max()) if len(ld) else 0,
        mean_depth=float(ld.mean()) if len(ld) else 0.0,
        min_tris=int(lt.min()) if len(lt) else 0,
        max_tris=int(lt.max()) if len(lt) else 0,
        mean_tris=float(lt.mean()) if len(lt) else 0.0,
        total_tris=int(lt.sum()),
    )


def _half_area(bmin, bmax) -> float:
    e = np.maximum(bmax - bmin, 0.0)
    return float(e[0] * e[1] + e[1] * e[2] + e[0] * e[2])


def _half_area_vec(bmin, bmax):
    e = np.maximum(bmax - bmin, 0.0)
    return e[..., 0] * e[..., 1] + e[..., 1] * e[..., 2] + e[..., 0] * e[..., 2]


def _best_binned_split(c, tmin, tmax, bb_min, bb_max):
    """Binned SAH over all 3 axes at once. Returns
    (cost, left_mask, axis, lmin, lmax, rmin, rmax) or None."""
    # Bin by centroid over the *centroid* extent of each axis.
    c_lo = c.min(axis=0)
    c_hi = c.max(axis=0)
    extent = c_hi - c_lo
    best = None
    for axis in range(3):
        if extent[axis] <= 0.0:
            continue
        scale = N_BINS / extent[axis]
        bins = np.clip(((c[:, axis] - c_lo[axis]) * scale).astype(np.int32),
                       0, N_BINS - 1)
        # Per-bin counts and bounds.
        counts = np.bincount(bins, minlength=N_BINS)
        bmin = np.full((N_BINS, 3), np.inf, np.float32)
        bmax = np.full((N_BINS, 3), -np.inf, np.float32)
        np.minimum.at(bmin, bins, tmin)
        np.maximum.at(bmax, bins, tmax)
        # Prefix/suffix sweeps.
        lcnt = np.cumsum(counts)[:-1]
        rcnt = counts.sum() - lcnt
        lmin = np.minimum.accumulate(bmin, axis=0)[:-1]
        lmax = np.maximum.accumulate(bmax, axis=0)[:-1]
        rmin = np.minimum.accumulate(bmin[::-1], axis=0)[::-1][1:]
        rmax = np.maximum.accumulate(bmax[::-1], axis=0)[::-1][1:]
        cost = lcnt * _half_area_vec(lmin, lmax) + rcnt * _half_area_vec(rmin, rmax)
        cost = np.where((lcnt == 0) | (rcnt == 0), np.inf, cost)
        k = int(np.argmin(cost))
        if not np.isfinite(cost[k]):
            continue
        if best is None or cost[k] < best[0]:
            mask = bins <= k
            best = (float(cost[k]), mask, axis,
                    lmin[k].copy(), lmax[k].copy(), rmin[k].copy(), rmax[k].copy())
    return best


def _midpoint_split(c, tmin, tmax, bb_min, bb_max):
    """Quality::Low: midpoint of the longest node axis (bvh.rs:314-322)."""
    e = bb_max - bb_min
    axis = int(np.argmax(e))
    pos = bb_min[axis] + e[axis] * 0.5
    mask = c[:, axis] < pos
    if not mask.any() or mask.all():
        return float("inf"), mask, axis, None, None, None, None
    lmin = tmin[mask].min(axis=0); lmax = tmax[mask].max(axis=0)
    rmin = tmin[~mask].min(axis=0); rmax = tmax[~mask].max(axis=0)
    cost = mask.sum() * _half_area(lmin, lmax) + (~mask).sum() * _half_area(rmin, rmax)
    return float(cost), mask, axis, lmin, lmax, rmin, rmax

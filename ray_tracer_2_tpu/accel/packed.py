"""Packed per-octant node rows — one gather per traversal step.

Dependent random gathers are latency-bound per ROW, and a row of up to 128
floats costs about what one float does. So the traversal's entire working set for one step is packed into a single
128-float row per (octant, node), and — crucially — an internal node's row
holds its CHILDREN's AABBs, so subtrees whose box misses are pruned without
ever fetching them (the currency is gathered rows, not tests):

  internal rows                      leaf rows
  ---------------------             -----------------------------
  0:3   near-child aabb min         16     first global triangle id
  3:6   near-child aabb max         17:25  material id per slot
  6:9   far-child aabb min          25:33  backface-cull flag per slot
  9:12  far-child aabb max          33:105 8 triangles × (v0,v1,v2)
  12    near-child row (float)
  13    far-child row
  shared: 14 skip row (-1 ends), 15 leaf count (0 ⇒ internal)

near/far are octant-ordered (accel/threading.py), so descent stays
near-first. A leaf's AABB is tested by its parent, so leaf visits go
straight to the inline triangle slab. Integer fields ride as floats (all
indices < 2^24, exact round trip).
"""
from __future__ import annotations

import numpy as np

from ray_tracer_2_tpu.accel.bvh import BVH
from ray_tracer_2_tpu.accel.threading import compute_skip_links

ROW_WIDTH = 128
#: leaf slots per row; must equal scene.LEAF_CHUNK
ROW_TRIS = 8

# column indices (shared with kernels/traverse.py)
COL_LINK_NEAR = 12
COL_LINK_FAR = 13
COL_SKIP = 14
COL_COUNT = 15
COL_FIRST = 16
COL_MATS = 17
COL_CULLS = 25
COL_TRIS = 33


def pack_octant_rows(bvh: BVH, v0, v1, v2, tri_mat, tri_cull,
                     node_offset: int, tri_offset: int) -> np.ndarray:
    """Build the (8, N, 64) packed rows for one group BVH.

    v0/v1/v2/tri_mat/tri_cull are the group's LEAF-ORDERED triangle arrays
    (already permuted by bvh.tri_order). Links/skip/first are globalized
    with node_offset/tri_offset.
    """
    n = bvh.n_nodes
    lhit, lmiss = compute_skip_links(bvh)
    left, right = bvh.node_left, bvh.node_right
    internal = bvh.node_count == 0

    base = np.zeros((n, ROW_WIDTH), np.float32)
    base[:, COL_COUNT] = bvh.node_count.astype(np.float32)
    base[:, COL_FIRST] = (bvh.node_first + tri_offset).astype(np.float32)

    # Inline leaf triangle slabs.
    leaves = np.flatnonzero(~internal)
    first = bvh.node_first[leaves]
    count = bvh.node_count[leaves]
    n_tris = len(v0)
    for j in range(ROW_TRIS):
        tri = np.minimum(first + j, max(n_tris - 1, 0))
        valid = j < count
        base[leaves, COL_MATS + j] = np.where(valid, tri_mat[tri], 0
                                              ).astype(np.float32)
        # invalid slots: cull=1 + degenerate zero triangle ⇒ guaranteed miss
        base[leaves, COL_CULLS + j] = np.where(valid, tri_cull[tri], 1.0)
        o = COL_TRIS + j * 9
        for k, arr in enumerate((v0, v1, v2)):
            vals = np.where(valid[:, None], arr[tri], 0.0)
            base[leaves, o + 3 * k:o + 3 * k + 3] = vals

    rows = np.zeros((8, n, ROW_WIDTH), np.float32)
    ints = np.flatnonzero(internal)
    for oct_ in range(8):
        r = base.copy()
        near = lhit[oct_][ints]  # near child (octant-ordered), local index
        far = np.where(near == left[ints], right[ints], left[ints])
        r[ints, 0:3] = bvh.node_min[near]
        r[ints, 3:6] = bvh.node_max[near]
        r[ints, 6:9] = bvh.node_min[far]
        r[ints, 9:12] = bvh.node_max[far]
        r[ints, COL_LINK_NEAR] = (near + node_offset).astype(np.float32)
        r[ints, COL_LINK_FAR] = (far + node_offset).astype(np.float32)
        r[:, COL_SKIP] = np.where(lmiss[oct_] >= 0,
                                  lmiss[oct_] + node_offset, -1
                                  ).astype(np.float32)
        rows[oct_] = r
    return rows


def pack_tri_attributes(n0, n1, n2, uv0, uv1, uv2,
                        v0=None, v1=None, v2=None) -> np.ndarray:
    """(T, 20) shading-attribute rows: normals (0:9), uvs (9:15), tangent
    (15:18) + bitangent handedness (18) — one gather resolves the winning
    triangle's attributes after traversal.

    The tangent frame feeds normal-map shading — the reference stubbed this
    out (ray_tracer.wgsl:440-447); here it is implemented behind
    RenderParams.normal_maps."""
    t = len(n0)
    attr = np.zeros((t, 20), np.float32)
    attr[:, 0:3] = n0
    attr[:, 3:6] = n1
    attr[:, 6:9] = n2
    attr[:, 9:11] = uv0
    attr[:, 11:13] = uv1
    attr[:, 13:15] = uv2
    if v0 is not None and t:
        e1 = (v1 - v0).astype(np.float64)
        e2 = (v2 - v0).astype(np.float64)
        d1 = (uv1 - uv0).astype(np.float64)
        d2 = (uv2 - uv0).astype(np.float64)
        r = d1[:, 0] * d2[:, 1] - d2[:, 0] * d1[:, 1]
        safe = np.where(np.abs(r) > 1e-12, r, 1.0)[:, None]
        tan = (e1 * d2[:, 1:2] - e2 * d1[:, 1:2]) / safe
        # degenerate UVs: any unit tangent orthogonal-ish to the normal works
        bad = (np.abs(r) <= 1e-12) | (np.linalg.norm(tan, axis=1) < 1e-12)
        gn = np.cross(e1, e2)
        alt = np.cross(gn, np.where(np.abs(gn[:, 0:1]) < 0.9,
                                    [[1.0, 0, 0]], [[0, 1.0, 0]]))
        tan = np.where(bad[:, None], alt, tan)
        ln = np.linalg.norm(tan, axis=1, keepdims=True)
        tan = tan / np.where(ln > 0, ln, 1.0)
        bit = (e2 * d1[:, 0:1] - e1 * d2[:, 0:1]) / safe
        hand = np.sign(np.sum(np.cross(gn, tan) * bit, axis=1))
        attr[:, 15:18] = tan.astype(np.float32)
        attr[:, 18] = np.where(hand == 0, 1.0, hand).astype(np.float32)
    return attr


def pack_attr_quads(attr: np.ndarray) -> np.ndarray:
    """(T, 20) attribute rows -> (ceil(T/4), 128) quad-packed rows: triangle
    t lives in row t//4, cols 32*(t%4) .. 32*(t%4)+20. 512-byte rows gather
    ~1.4x faster than the narrow 80-byte layout (kernels/gatherlib.py
    fetch_attr); padding cols are zero."""
    t = attr.shape[0]
    t4 = (t + 3) // 4
    out = np.zeros((t4 * 4, 32), np.float32)
    out[:t, :attr.shape[1]] = attr
    return out.reshape(t4, 128)

"""Simulate NATIVE leaf-size rebuilds on the real dragon BVH.

sim_wide256.py showed post-hoc sibling-leaf MERGING barely cuts leaf fetches
(adjacent mergeable ranges are rare) and 64-ary inner rows don't beat 32-ary.
This instead REBUILDS the binary BVH with max_leaf in {8, 16, 32} (the SAH
stops splitting earlier), collapses 32-ary, and counts inner/leaf row fetches
under the kernel's nearest-first mask-stack traversal.

Row widths: L=8 -> 128-col rows (512 B), L=16 -> 256-col rows (1 KB),
L=32 -> 512-col rows (2 KB). What a wider row costs per fetch on the H100
is not measured yet, so the script reports fetch counts and the total
BYTES fetched; tri_tests is the arithmetic side.
"""
from __future__ import annotations

import json
import sys

import numpy as np

sys.path.insert(0, "/root/repo")

from ray_tracer_2_tpu.accel.bvh import build_bvh  # noqa: E402
from ray_tracer_2_tpu.accel.wide import collapse  # noqa: E402
from scripts.sim_treelet import build_scene, ray_dirs, trace_visits  # noqa

INF = np.float32(1.7014118e38)


def visits(bvh, v0, v1, v2, om, dm):
    """Nearest-first mask-stack traversal over the 32-ary collapse of
    ``bvh``; returns per-ray (inner fetches, leaf fetches, tri tests)."""
    wb = collapse(bvh, 32)
    count = bvh.node_count
    first = bvh.node_first
    nmin, nmax = bvh.node_min, bvh.node_max
    order = bvh.tri_order
    lv0, lv1, lv2 = v0[order], v1[order], v2[order]

    inner_f = np.zeros(len(om), np.int64)
    leaf_f = np.zeros(len(om), np.int64)
    tri_t = np.zeros(len(om), np.int64)
    for i in range(len(om)):
        oi, di = om[i], dm[i]
        inv = 1.0 / np.where(np.abs(di) > 1e-30, di, 1e-30)
        best = INF
        n_in, n_lf, n_tt = 1, 0, 0  # root row is inlined in the kernel but
        #                             counted here like sim_wide256 (relative
        #                             comparison only)

        def slab(c):
            t1 = (nmin[c] - oi) * inv
            t2 = (nmax[c] - oi) * inv
            tn = np.minimum(t1, t2).max()
            tf = np.maximum(t1, t2).min()
            return tn if (tf >= tn and tn < best and tf > 0) else INF

        def leaf_hit(nd):
            nonlocal best, n_tt
            f0, k = int(first[nd]), int(count[nd])
            n_tt += k
            for t in range(f0, f0 + k):
                e1, e2 = lv1[t] - lv0[t], lv2[t] - lv0[t]
                nrm = np.cross(e1, e2)
                det = -np.dot(di, nrm)
                if abs(det) < 1e-8:
                    continue
                ao = oi - lv0[t]
                dao = np.cross(ao, di)
                dst = np.dot(ao, nrm) / det
                u = np.dot(e2, dao) / det
                v = -np.dot(e1, dao) / det
                if dst > 1e-5 and u >= 0 and v >= 0 and u + v <= 1 \
                        and dst < best:
                    best = dst

        if wb.root_is_leaf:
            leaf_hit(0)
            leaf_f[i] += 1
            continue
        stack = [wb.children[wb.wide_of[0]]]
        while stack:
            kids = stack.pop()
            hits = []
            for c in kids:
                dn = slab(c)
                if dn < INF:
                    hits.append((dn, c))
            hits.sort(key=lambda x: x[0])
            for _, c in hits:
                if count[c] > 0:
                    n_lf += 1
                    leaf_hit(c)
                else:
                    n_in += 1
                    stack.append(wb.children[wb.wide_of[c]])
        inner_f[i], leaf_f[i], tri_t[i] = n_in, n_lf, n_tt
    return inner_f, leaf_f, tri_t


def main():
    scene = build_scene()
    # raw model-space triangles of the dragon group (leaf order of the
    # ORIGINAL build — order-independent input to the rebuilds)
    import bench
    host = bench.dragon_scene()
    bvh0, v0, v1, v2 = host._staging[0][:4]
    w2m = np.asarray(scene.inst_world_to_model[0], np.float32)
    m2w = np.asarray(scene.inst_model_to_world[0], np.float32)
    W, H = 1920, 1080
    ys, xs = np.meshgrid(np.arange(500, 532), np.arange(940, 972),
                         indexing="ij")
    pixels = (ys * W + xs).ravel()
    o, d = ray_dirs(scene, pixels, W, H)

    _, hits = trace_visits(scene, o, d, w2m)
    rng = np.random.default_rng(0)
    bo, bd = [], []
    for dst, n, hp_model in hits:
        if n is None:
            continue
        hp = hp_model @ m2w[:3, :3].T + m2w[:3, 3]
        nw = n @ m2w[:3, :3].T
        nw /= np.linalg.norm(nw)
        v = rng.normal(size=3)
        v /= np.linalg.norm(v)
        dirn = nw + v
        nl = np.linalg.norm(dirn)
        bo.append(hp + 1e-4 * nw)
        bd.append(nw if nl < 1e-6 else dirn / nl)
    bo = np.asarray(bo, np.float32)
    bd = np.asarray(bd, np.float32)

    def to_model(o_, d_):
        om = o_ @ w2m[:3, :3].T + w2m[:3, 3]
        dm = d_ @ w2m[:3, :3].T
        dm /= np.linalg.norm(dm, axis=1, keepdims=True)
        return om, dm

    for L in (8, 16, 32):
        row_bytes = 512 * L // 8   # one uniform table row
        bvh = build_bvh(v0, v1, v2, max_leaf=L)
        for tag, (oo, dd) in (("primary", (o, d)), ("bounce", (bo, bd))):
            om, dm = to_model(oo, dd)
            fi, fl, tt = visits(bvh, v0, v1, v2, om, dm)
            tot = fi + fl
            print(json.dumps(dict(
                leaf=L, tag=tag,
                mean=round(float(tot.mean()), 2),
                kib=round(float(tot.mean()) * row_bytes / 1024, 2),
                inner=round(float(fi.mean()), 2),
                leaves=round(float(fl.mean()), 2),
                tri_tests=round(float(tt.mean()), 1),
                p95=int(np.percentile(tot, 95)))), flush=True)


if __name__ == "__main__":
    main()

"""Simulate fetch counts for 256-float wide rows on the real dragon BVH.

Variants (mask/resume-stack scheme, per-ray nearest-first):
  w16      current: 16-ary inner rows, 8-tri leaf rows      (128 f32 rows)
  w32      32-ary inner rows, 8-tri leaf rows               (256 f32 rows)
  w32m16   32-ary inner rows + adjacent sibling leaves merged to <=16 tris
           (union AABB in the parent slot)                   (256 f32 rows)
  w16m16   16-ary + merged leaves                            (256 f32 rows)

Decision rule: a 256-row variant wins iff its fetch-count saving beats the
measured per-fetch cost ratio of 256- vs 128-f32 rows on the card (not
measured on the H100 yet). Reports inner/leaf split and the mean triangle
tests per segment (arithmetic cost).
"""
from __future__ import annotations

import json
import sys

import numpy as np

sys.path.insert(0, "/root/repo")

from scripts.sim_treelet import build_scene, ray_dirs, trace_visits  # noqa
from scripts.sim_wide import collapse  # noqa

INF = np.float32(1.7014118e38)


def make_wide(scene, K, merge_leaf):
    """Collapse + optional adjacent-sibling leaf merging. Returns
    (children: list of lists of entries, wide_of) where an entry is either
    ("i", binary_id) or ("l", first, count, bbox)."""
    wide_children, wide_of, _ = collapse(scene, K)
    count = np.asarray(scene.node_count)
    first = np.asarray(scene.node_first)
    nmin = np.asarray(scene.node_min)
    nmax = np.asarray(scene.node_max)

    out = []
    for kids in wide_children:
        entries = []
        for c in kids:
            if count[c] > 0:
                entries.append(["l", int(first[c]), int(count[c]),
                                nmin[c].copy(), nmax[c].copy()])
            else:
                entries.append(["i", c])
        if merge_leaf:
            # greedy: merge leaves with contiguous tri ranges, sum <= 16
            entries.sort(key=lambda e: e[1] if e[0] == "l" else -1)
            merged = []
            for e in entries:
                if (e[0] == "l" and merged and merged[-1][0] == "l"
                        and merged[-1][1] + merged[-1][2] == e[1]
                        and merged[-1][2] + e[2] <= merge_leaf):
                    m = merged[-1]
                    m[2] += e[2]
                    m[3] = np.minimum(m[3], e[3])
                    m[4] = np.maximum(m[4], e[4])
                else:
                    merged.append(e)
            entries = merged
        out.append(entries)
    return out, wide_of


def visits(scene, o, d, w2m, K, merge_leaf):
    children, wide_of = make_wide(scene, K, merge_leaf)
    nmin = np.asarray(scene.node_min)
    nmax = np.asarray(scene.node_max)
    v0 = np.asarray(scene.tri_v0)
    v1 = np.asarray(scene.tri_v1)
    v2 = np.asarray(scene.tri_v2)

    om = o @ w2m[:3, :3].T + w2m[:3, 3]
    dm = d @ w2m[:3, :3].T
    dm /= np.linalg.norm(dm, axis=1, keepdims=True)

    inner_f, leaf_f, tri_t, arity_used = [], [], [], []
    for i in range(len(o)):
        oi, di = om[i], dm[i]
        inv = 1.0 / np.where(np.abs(di) > 1e-30, di, 1e-30)
        best = INF
        n_in, n_lf, n_tt = 1, 0, 0  # root inner fetch

        def slab(lo, hi):
            t1 = (lo - oi) * inv
            t2 = (hi - oi) * inv
            tn = np.minimum(t1, t2).max()
            tf = np.maximum(t1, t2).min()
            return tn if (tf >= tn and tn < best and tf > 0) else INF

        def leaf_hit(f0, k):
            nonlocal best, n_tt
            n_tt += k
            for t in range(f0, f0 + k):
                e1, e2 = v1[t] - v0[t], v2[t] - v0[t]
                nrm = np.cross(e1, e2)
                det = -np.dot(di, nrm)
                if abs(det) < 1e-8:
                    continue
                ao = oi - v0[t]
                dao = np.cross(ao, di)
                dst = np.dot(ao, nrm) / det
                u = np.dot(e2, dao) / det
                v = -np.dot(e1, dao) / det
                if dst > 1e-5 and u >= 0 and v >= 0 and u + v <= 1 \
                        and dst < best:
                    best = dst

        stack = [children[wide_of[0]]]
        while stack:
            entries = stack.pop()
            arity_used.append(len(entries))
            # nearest-first: order hit entries by entry distance
            hits = []
            for e in entries:
                if e[0] == "l":
                    dn = slab(e[3], e[4])
                else:
                    dn = slab(nmin[e[1]], nmax[e[1]])
                if dn < INF:
                    hits.append((dn, e))
            hits.sort(key=lambda x: x[0])
            for _, e in hits:
                if e[0] == "l":
                    n_lf += 1
                    leaf_hit(e[1], e[2])
                else:
                    n_in += 1
                    stack.append(children[wide_of[e[1]]])
        inner_f.append(n_in)
        leaf_f.append(n_lf)
        tri_t.append(n_tt)
    return (np.array(inner_f), np.array(leaf_f), np.array(tri_t),
            np.array(arity_used))


def main():
    scene = build_scene()
    w2m = np.asarray(scene.inst_world_to_model[0], np.float32)
    W, H = 1920, 1080
    ys, xs = np.meshgrid(np.arange(500, 532), np.arange(940, 972),
                         indexing="ij")
    pixels = (ys * W + xs).ravel()
    o, d = ray_dirs(scene, pixels, W, H)

    _, hits = trace_visits(scene, o, d, w2m)
    rng = np.random.default_rng(0)
    m2w = np.asarray(scene.inst_model_to_world[0], np.float32)
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

    for name, K, ml in (("w16", 16, 0), ("w32", 32, 0),
                        ("w16m16", 16, 16), ("w32m16", 32, 16),
                        ("w32m12", 32, 12),
                        ("w64", 64, 0), ("w64m16", 64, 16),
                        ("w64m24", 64, 24)):
        for tag, (oo, dd) in (("primary", (o, d)), ("bounce", (bo, bd))):
            fi, fl, tt, au = visits(scene, oo, dd, w2m, K, ml)
            tot = fi + fl
            print(json.dumps(dict(
                variant=name, tag=tag,
                mean=round(float(tot.mean()), 2),
                inner=round(float(fi.mean()), 2),
                leaf=round(float(fl.mean()), 2),
                tri_tests=round(float(tt.mean()), 1),
                p95=int(np.percentile(tot, 95)))), flush=True)


if __name__ == "__main__":
    main()

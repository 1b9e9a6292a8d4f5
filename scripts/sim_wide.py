"""Simulate 16-ary (wide) BVH traversal fetch counts on the real dragon BVH.

Compares, per segment (primary + diffuse-bounce chunks):
  binary   current packed-row skip-link scheme (1 fetch per node visit)
  skipK    K-ary collapse with conservative skip-link threading
           (missed later-siblings are passed through: 1 fetch each)
  maskK    K-ary with a per-lane (node, hitmask) resume stack
           (fetches = only box-hit nodes; the extra loop carries this
           would cost are priced separately)

Fetch count is the currency while traversal is bound by dependent row
gathers whose cost barely depends on row width up to 512 B.
"""
from __future__ import annotations

import json
import sys

import numpy as np

sys.path.insert(0, "/root/repo")

from scripts.sim_treelet import (build_scene, ray_dirs, trace_visits)  # noqa

INF = np.float32(1.7014118e38)


def collapse(scene, K):
    """Collapse the binary BVH into K-ary wide nodes. Children of a wide
    node are binary-node ids (internal ids get their own wide node; leaf ids
    are leaf rows). Returns (wide_children: list[list[int]], wide_of: dict
    binary id -> wide id for internal roots, subtree tri counts)."""
    left = np.asarray(scene.node_left)
    right = np.asarray(scene.node_right)
    count = np.asarray(scene.node_count)
    n = len(count)
    tris = np.zeros(n, np.int64)
    # post-order subtree triangle counts
    order = []
    stack = [(0, False)]
    while stack:
        nd, done = stack.pop()
        if done:
            tris[nd] = count[nd] if count[nd] else tris[left[nd]] + tris[right[nd]]
            continue
        stack.append((nd, True))
        if count[nd] == 0:
            stack.append((int(left[nd]), False))
            stack.append((int(right[nd]), False))

    wide_children = []
    wide_of = {}
    pending = [0]
    while pending:
        root = pending.pop()
        frontier = [root] if count[root] else [int(left[root]), int(right[root])]
        while len(frontier) < K:
            internals = [c for c in frontier if count[c] == 0]
            if not internals:
                break
            big = max(internals, key=lambda c: tris[c])
            frontier.remove(big)
            frontier += [int(left[big]), int(right[big])]
        wid = len(wide_children)
        wide_children.append(frontier)
        wide_of[root] = wid
        for c in frontier:
            if count[c] == 0:
                pending.append(c)
    return wide_children, wide_of, tris


def wide_visits(scene, o, d, w2m, K, masked):
    """Per-ray fetch counts through the K-ary structure. masked=True models
    the resume-stack variant (only hit children fetched); masked=False the
    conservative skip-link chain (later siblings passed through)."""
    wide_children, wide_of, _ = collapse(scene, K)
    nmin = np.asarray(scene.node_min)
    nmax = np.asarray(scene.node_max)
    count = np.asarray(scene.node_count)
    first = np.asarray(scene.node_first)
    v0 = np.asarray(scene.tri_v0)
    v1 = np.asarray(scene.tri_v1)
    v2 = np.asarray(scene.tri_v2)

    om = o @ w2m[:3, :3].T + w2m[:3, 3]
    dm = d @ w2m[:3, :3].T
    dm /= np.linalg.norm(dm, axis=1, keepdims=True)

    fetches = []
    for i in range(len(o)):
        oi, di = om[i], dm[i]
        inv = 1.0 / np.where(np.abs(di) > 1e-30, di, 1e-30)
        best = INF
        nf = 0

        def slab(c):
            t1 = (nmin[c] - oi) * inv
            t2 = (nmax[c] - oi) * inv
            tn = np.minimum(t1, t2).max()
            tf = np.maximum(t1, t2).min()
            return tn if (tf >= tn and tn < best and tf > 0) else INF

        def leaf_hit(c):
            nonlocal best
            for t in range(first[c], first[c] + count[c]):
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

        centroid = (nmin + nmax) * 0.5
        octdir = np.sign(di)

        def enter(kids, stack):
            """Static octant-precedence ordering (what the packed links
            encode): children sorted by centroid projection along the ray's
            octant direction; first entered = first HIT in that order."""
            order = sorted(range(len(kids)),
                           key=lambda j: float(centroid[kids[j]] @ octdir))
            hits = [j for j in order if slab(kids[j]) < INF]
            if not hits:
                return
            if masked:
                for j in reversed(hits):
                    c = kids[j]
                    stack.append(("w", c, True))
            else:
                jpos = order.index(hits[0])
                chain = [kids[j] for j in order[jpos:]]
                for c in reversed(chain[1:]):
                    stack.append(("w", c, False))   # skip-chain passthrough
                stack.append(("w", chain[0], True))

        stack = []
        nf += 1  # root wide row fetch
        enter(wide_children[wide_of[0]], stack)
        while stack:
            _, x, _was_hit = stack.pop()
            nf += 1
            if count[x]:
                leaf_hit(x)
            else:
                enter(wide_children[wide_of[x]], stack)
        fetches.append(nf)

    return np.array(fetches)


def main():
    scene = build_scene()
    global _is_leaf, _wide_id
    count = np.asarray(scene.node_count)

    w2m = np.asarray(scene.inst_world_to_model[0], np.float32)
    W, H = 1920, 1080
    ys, xs = np.meshgrid(np.arange(500, 532), np.arange(940, 972),
                         indexing="ij")
    pixels = (ys * W + xs).ravel()
    o, d = ray_dirs(scene, pixels, W, H)

    bseqs, hits = trace_visits(scene, o, d, w2m)
    lens = np.array([len(s) for s in bseqs])
    print(json.dumps(dict(variant="binary", tag="primary",
                          mean=float(lens.mean()))), flush=True)

    # bounce rays from primary hits (same recipe as sim_treelet)
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
    bo, bd = np.asarray(bo, np.float32), np.asarray(bd, np.float32)
    b2, _ = trace_visits(scene, bo, bd, w2m)
    print(json.dumps(dict(variant="binary", tag="bounce",
                          mean=float(np.mean([len(s) for s in b2])))),
          flush=True)

    for K in (4, 8, 16):
        wc, wo, _ = collapse(scene, K)
        _is_leaf = lambda c: count[c] > 0          # noqa: E731
        _wide_id = lambda c, _wo=wo: _wo[c]        # noqa: E731
        for masked in (False, True):
            for tag, (oo, dd) in (("primary", (o, d)), ("bounce", (bo, bd))):
                f = wide_visits(scene, oo, dd, w2m, K, masked)
                print(json.dumps(dict(
                    variant=("mask" if masked else "skip") + str(K),
                    tag=tag, mean=round(float(f.mean()), 1),
                    p95=int(np.percentile(f, 95)))), flush=True)


if __name__ == "__main__":
    main()

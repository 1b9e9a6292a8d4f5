"""Ray-PACKET traversal simulator (CPU, numpy) on the real dragon BVH.

Decision question: if the dragon megakernel is bound by dependent row
fetches and those are ~100% useful, the remaining idea is P rays per lane
sharing each row fetch (union traversal). Fetches per ray can only go
DOWN (a packet fetches each row at most once where P scalar rays fetch it
up to P times), at the cost of: P x the slab/leaf arithmetic per fetch,
P x the lane state, and union-inflated rows per packet-segment (a packet
visits rows ANY of its rays needs).

This sim replays nearest-first mask-stack traversal over the 32-ary
collapse of the real dragon BVH (same scheme as kernels/megakernel.py)
for P in {1, 2, 4, 8} on:
  - primary rays (2x2 / 2x4 pixel blocks — the coherent best case)
  - one diffuse bounce from the primary hits (uniform hemisphere — the
    reference's diffuse; packets inherit the pixel-block grouping)

and reports total row fetches, the reduction vs scalar, per-fetch live-ray
occupancy (a proxy for idle SIMD lanes), and a projected frame-level fetch reduction
weighted by the real segment mix (3.39M segments/frame = 2.07M primary +
1.32M bounce at 1080p/5 bounces on the dragon; segment counts do not
depend on the hardware).

Run (CPU): env JAX_PLATFORMS=cpu \
    python scripts/sim_packet.py [n_blocks]
"""
from __future__ import annotations

import json
import sys

import numpy as np

sys.path.insert(0, "/root/repo")

INF = np.float32(3.4e38)


def build():
    from bench import dragon_scene
    from ray_tracer_2_tpu.accel.wide import collapse

    host = dragon_scene()
    rs = host.render_scene
    (bvh, v0, v1, v2, mats, node_off, tri_off, deltas) = host._staging[0]
    wide = collapse(bvh, 32)
    # staging triangle arrays are ALREADY leaf-ordered (node_first indexes
    # them directly — verified: leaf AABBs contain their [first, first+k)
    # range of the staging arrays, not of a re-permuted copy)
    tv0, tv1, tv2 = v0, v1, v2
    w2m = np.asarray(rs.inst_world_to_model[0], np.float32)
    return rs, bvh, wide, tv0, tv1, tv2, w2m


def cam_rays(rs, pixels, width=1920, height=1080):
    cam = np.asarray(rs.cam_to_world, np.float32)
    vp = np.asarray(rs.view_params, np.float32)
    x = (pixels % width).astype(np.float32)
    y = (pixels // width).astype(np.float32)
    u = x / (width - 1.0)
    v = y / (height - 1.0)
    lf = np.stack([(u - 0.5) * vp[0], (v - 0.5) * vp[1],
                   np.full_like(u, vp[2])], axis=1)
    fp = lf @ cam[:3, :3].T + cam[:3, 3]
    o = np.broadcast_to(cam[:3, 3], fp.shape).copy()
    d = fp - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def to_model(o, d, w2m):
    om = o @ w2m[:3, :3].T + w2m[:3, 3]
    dm = d @ w2m[:3, :3].T
    n = np.linalg.norm(dm, axis=1, keepdims=True)
    return om, dm / n, n[:, 0]


def slab(nmin, nmax, o, inv, best):
    """Vectorized over rays AND boxes: o/inv (P,3), nmin/nmax (C,3)."""
    t1 = (nmin[None, :, :] - o[:, None, :]) * inv[:, None, :]
    t2 = (nmax[None, :, :] - o[:, None, :]) * inv[:, None, :]
    tn = np.minimum(t1, t2).max(axis=2)
    tf = np.maximum(t1, t2).min(axis=2)
    hit = (tf >= tn) & (tf > 0.0) & (tn < best[:, None])
    return hit, np.where(hit, np.maximum(tn, 0.0), INF)


def mt(v0, v1, v2, o, d, best):
    """Möller–Trumbore over (P rays) x (T tris); returns updated best."""
    e1 = v1 - v0
    e2 = v2 - v0
    n = np.cross(e1, e2)
    det = -np.einsum("pc,tc->pt", d, n)
    keep = np.abs(det) >= 1e-8
    invd = 1.0 / np.where(keep, det, 1.0)
    ao = o[:, None, :] - v0[None, :, :]
    dao = np.cross(ao, d[:, None, :] * -1.0) * -1.0
    u = np.einsum("tc,ptc->pt", e2, dao) * invd
    v = -np.einsum("tc,ptc->pt", e1, dao) * invd
    dst = np.einsum("ptc,tc->pt", ao, n) * invd
    ok = keep & (dst > 1e-5) & (u >= 0) & (v >= 0) & (u + v <= 1.0) \
        & (dst < best[:, None])
    any_hit = ok.any(axis=1)
    dmin = np.where(ok, dst, INF).min(axis=1)
    tri = np.where(ok, dst, INF).argmin(axis=1)
    return np.where(any_hit, dmin, best), any_hit, tri


def traverse_packet(bvh, wide, tv0, tv1, tv2, o, d, best0=None):
    """Union nearest-first traversal for a packet of P rays.

    Returns (rows_fetched, live_ray_fetch_sum, bests, hit_tri).
    live_ray_fetch_sum / (rows * P) = per-fetch occupancy."""
    P = len(o)
    inv = 1.0 / np.where(np.abs(d) > 1e-30, d, 1e-30)
    best = np.full(P, INF, np.float32) if best0 is None else best0.copy()
    hit_tri = np.full(P, -1, np.int64)
    count = bvh.node_count
    first = bvh.node_first
    nmin, nmax = bvh.node_min, bvh.node_max

    rows = 0
    live_sum = 0

    def leaf_fetch(b):
        nonlocal rows, live_sum, best
        f, c = int(first[b]), int(count[b])
        rows += 1
        live_sum += P
        nb, anyh, tri = mt(tv0[f:f+c], tv1[f:f+c], tv2[f:f+c], o, d, best)
        upd = nb < best
        hit_tri[upd] = (f + tri)[upd]
        best[:] = nb

    # stack entries: (min_entry_dist, [children binary ids remaining])
    if wide.root_is_leaf:
        leaf_fetch(0)
        return rows, live_sum, best, hit_tri

    stack = [(np.zeros(P, np.float32), [0])]   # binary root as sole child
    while stack:
        dists, rem = stack.pop()
        # pop-time pruning: per-ray entry distance vs per-ray best
        if not (dists < best).any():
            continue
        child = rem.pop(0)
        if rem:
            stack.append((dists, rem))
        if count[child] > 0:
            leaf_fetch(child)
            continue
        w = wide.wide_of[child]
        kids = wide.children[w]
        rows += 1
        live_sum += int((dists < best).sum())
        hit, tn = slab(nmin[kids], nmax[kids], o, inv, best)
        anyh = hit.any(axis=0)
        if not anyh.any():
            continue
        # nearest-first by min-over-rays entry distance
        tmin = tn.min(axis=0)
        ordi = np.argsort(tmin[anyh], kind="stable")
        live_kids = [int(k) for k in np.nonzero(anyh)[0][ordi]]
        # push in REVERSE so nearest pops first; each entry carries the
        # per-ray entry distances of that child (INF where the ray missed)
        for k in reversed(live_kids):
            stack.append((tn[:, k].copy(), [kids[k]]))
    return rows, live_sum, best, hit_tri


def hemisphere(n, rng):
    """Uniform hemisphere around n (reference diffuse, wgsl pdf 1/2pi)."""
    v = rng.normal(size=3).astype(np.float32)
    v /= np.linalg.norm(v)
    if np.dot(v, n) < 0:
        v = -v
    return v


def run(P, blocks_o, blocks_d, bvh, wide, tv0, tv1, tv2, rng):
    """blocks_*: (NB, Pmax, 3) model-space rays grouped by pixel block."""
    NB = blocks_o.shape[0]
    tot_rows = 0
    tot_live = 0
    bounce_o, bounce_d, bounce_grp = [], [], []
    for b in range(NB):
        for s in range(0, blocks_o.shape[1], P):
            o = blocks_o[b, s:s+P]
            d = blocks_d[b, s:s+P]
            rows, live, best, hit_tri = traverse_packet(
                bvh, wide, tv0, tv1, tv2, o, d)
            tot_rows += rows
            tot_live += live
            for j in range(len(o)):
                if hit_tri[j] >= 0:
                    t = int(hit_tri[j])
                    e1 = tv1[t] - tv0[t]
                    e2 = tv2[t] - tv0[t]
                    n = np.cross(e1, e2)
                    n /= np.linalg.norm(n)
                    if np.dot(n, d[j]) > 0:
                        n = -n
                    hp = o[j] + d[j] * best[j] + n * 1e-4
                    bounce_o.append(hp)
                    bounce_d.append(hemisphere(n, rng))
                    bounce_grp.append(b)
    prim = dict(rows=tot_rows, live=tot_live)

    # bounce pass: packets re-formed WITHIN the original pixel block
    tot_rows = 0
    tot_live = 0
    n_bounce = len(bounce_o)
    if n_bounce:
        bo = np.asarray(bounce_o, np.float32)
        bd = np.asarray(bounce_d, np.float32)
        grp = np.asarray(bounce_grp)
        for b in np.unique(grp):
            idx = np.nonzero(grp == b)[0]
            for s in range(0, len(idx), P):
                sel = idx[s:s+P]
                rows, live, _, _ = traverse_packet(
                    bvh, wide, tv0, tv1, tv2, bo[sel], bd[sel])
                tot_rows += rows
                tot_live += live
    bnc = dict(rows=tot_rows, live=tot_live, n=n_bounce)
    return prim, bnc


def main():
    n_blocks = int(sys.argv[1]) if len(sys.argv) > 1 else 512
    rs, bvh, wide, tv0, tv1, tv2, w2m = build()
    rng = np.random.default_rng(0)
    # random 2x4 pixel blocks (8 rays) across the full frame
    bx = rng.integers(0, (1920 - 2) // 2, n_blocks) * 2
    by = rng.integers(0, (1080 - 4) // 4, n_blocks) * 4
    pix = []
    for x0, y0 in zip(bx, by):
        pix.append([(y0 + dy) * 1920 + (x0 + dx)
                    for dy in range(4) for dx in range(2)])
    pix = np.asarray(pix)
    o, d = cam_rays(rs, pix.ravel())
    om, dm, _ = to_model(o, d, w2m)
    blocks_o = om.reshape(n_blocks, 8, 3)
    blocks_d = dm.reshape(n_blocks, 8, 3)

    base_prim = base_bnc = None
    out = {}
    for P in (1, 2, 4, 8):
        prim, bnc = run(P, blocks_o, blocks_d, bvh, wide, tv0, tv1, tv2,
                        np.random.default_rng(7))  # same bounce stream
        if P == 1:
            base_prim, base_bnc = prim, bnc
        red_p = base_prim["rows"] / prim["rows"]
        red_b = base_bnc["rows"] / max(bnc["rows"], 1)
        occ_p = prim["live"] / (prim["rows"] * P)
        occ_b = bnc["live"] / max(bnc["rows"] * P, 1)
        # frame mix: 61% primary segments, 39% bounce (dragon, 1080p)
        mix = 1.0 / (0.61 / red_p + 0.39 / red_b)
        out[P] = dict(prim_rows=prim["rows"], bounce_rows=bnc["rows"],
                      red_prim=round(red_p, 2), red_bounce=round(red_b, 2),
                      occ_prim=round(occ_p, 2), occ_bounce=round(occ_b, 2),
                      red_frame_mix=round(mix, 2))
        print(json.dumps(dict(P=P, **out[P])), flush=True)


if __name__ == "__main__":
    main()

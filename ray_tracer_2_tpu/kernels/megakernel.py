"""Flat single-loop path tracer for BVH scenes ("megakernel" state machine).

The layered loop (bounce while → per-instance for → traversal while) makes
every ray wait at every bounce for the slowest ray in the batch — most rays
terminate after 1-2 segments while a few trace deep paths. Here the whole
path runs in ONE while_loop: each ray advances its own (segment, instance,
node) state every iteration, and the expensive segment-boundary work
(shading + RNG + sphere and brute-force prepass for the next segment) runs
as a masked phase gated by ``lax.cond`` every SHADE_EVERY iterations, so
its cost is amortized while traversal — one compact 32-ary wide-row
gather per step (accel/wide.py; ~4x fewer dependent gathers than binary
skip links) — stays the steady-state body.

Two entry points share the same parts:

* ``trace_batch_flat`` — fixed ray batch, drop-in for kernels/trace.py's
  ``trace_batch``.
* ``render_persistent`` — PERSISTENT LANES: a fixed batch of lanes consumes
  the whole image as a work queue. When a lane finishes a pixel (all
  rays_per_pixel samples), it scatters the result into the framebuffer and
  claims the next pixel from a cursor, so lanes stay busy regardless of how
  uneven per-pixel path lengths are — the persistent-threads megakernel
  design, and the fix for lockstep waste across tiles.

Ray phase encoding (int state):
  bounce == -2                lane idle, needs to claim a pixel (persistent)
  bounce == -1                ray primed, first boundary skips shading
  cur >= 0                    traversing BVH instance bvh_ptr
  cur == -1, bvh_ptr < n_bvh  instance finished → merge, advance (inline)
  cur == -1, bvh_ptr == n_bvh segment done → wait for the boundary phase
  bounce == DONE              terminated

Physics is identical to kernels/trace.py (same RNG stream, same shading) —
tested bit-compatible.
"""
from __future__ import annotations

import math

import jax
import jax.numpy as jnp

from ray_tracer_2_tpu import rng, tuning
from ray_tracer_2_tpu.kernels.brute import brute_force_intersect, brute_max
from ray_tracer_2_tpu.kernels.gatherlib import fetch_attr
from ray_tracer_2_tpu.kernels.intersect import INF, ray_sphere, \
    ray_sphere_fast, ray_triangle, sphere_normal_uv, \
    sphere_fast_min as _sphere_fast_min
from ray_tracer_2_tpu.kernels.texture import sample_texture
from ray_tracer_2_tpu.math.vec import dot, lerp, normalize, reflect, refract
from ray_tracer_2_tpu.scene.render_scene import LEAF_CHUNK, RenderScene

SHADE_EVERY = 1   # boundary cadence for the GATED variants (shade_every>0);
                  # render_persistent defaults to 0 = UNGATED: the boundary
                  # runs inline every iteration, so XLA overlaps its
                  # dependent gathers with the traversal window's (the
                  # lax.cond is a scheduling barrier)
DONE = 1 << 20    # bounce sentinel for terminated rays
IDLE = -2         # bounce sentinel for lanes awaiting a pixel claim

GLASS = 1
TEXTURE = 2

class ColState:
    """Int lane-state carried as SEPARATE (B,) columns.

    Presents the same ``I[:, col]`` / ``I.at[:, col].set(v)`` interface as
    the packed (B, 16) array it replaces, but each column is its own
    while-loop carry: the packed form lowered every column write to a
    chained (B, 1) dynamic-update-slice on the full array, while separate
    carries update for free."""

    __slots__ = ("vals",)

    def __init__(self, vals):
        self.vals = tuple(vals)

    def __getitem__(self, key):
        _, c = key
        return self.vals[c]

    @property
    def at(self):
        return _ColAt(self)


class _ColAt:
    __slots__ = ("cs",)

    def __init__(self, cs):
        self.cs = cs

    def __getitem__(self, key):
        _, c = key
        return _ColAtCol(self.cs, c)


class _ColAtCol:
    __slots__ = ("cs", "c")

    def __init__(self, cs, c):
        self.cs, self.c = cs, c

    def _check(self, v):
        # A scalar (or wrong-dtype) column would silently desync the
        # while_loop carry pytree — catch it at the call site instead.
        old = self.cs.vals[self.c]
        assert getattr(v, "shape", None) == old.shape \
            and getattr(v, "dtype", None) == old.dtype, \
            f"ColState col {self.c}: {getattr(v, 'shape', v)}/" \
            f"{getattr(v, 'dtype', type(v))} != {old.shape}/{old.dtype}"

    def set(self, v):
        self._check(v)
        vals = list(self.cs.vals)
        vals[self.c] = v
        return ColState(vals)

    def add(self, v):
        vals = list(self.cs.vals)
        new = vals[self.c] + v
        self._check(new)
        vals[self.c] = new
        return ColState(vals)


jax.tree_util.register_pytree_node(
    ColState, lambda cs: (cs.vals, None),
    lambda _, vals: ColState(vals))


# I-state column map (I_SP = wide-traversal resume-stack pointer; I_NEE =
# "previous bounce sampled a light via NEE" — suppresses the next hit's
# surface-emission term to avoid double counting; always 0 when nee is off)
I_SEED, I_BOUNCE, I_SEGS, I_CUR, I_PTR, I_TRI, I_MAT, I_STRI, I_SMAT, \
    I_FLAG, I_SN, I_ST, I_PIXEL, I_SAMPLE, I_SP, I_NEE = range(16)

#: float32 products run at full precision: a GPU may otherwise run them in
#: TF32 (~3 decimal digits), enough to move a hit point past the small
#: offsets that keep a bounce from re-hitting its own surface
HIGHEST = jax.lax.Precision.HIGHEST


def _matvec(m, v):
    """Batched (B, 3, 3) @ (B, 3) at full float32 precision."""
    return jnp.einsum("bij,bj->bi", m, v, precision=HIGHEST)


def f16_bits_to_f32(bits):
    """f16 bit patterns (low 16 bits of a uint32) -> float32, exact for
    every pattern, subnormals included (no detour through f32 denormals,
    which a flush-to-zero backend would zero)."""
    return jax.lax.bitcast_convert_type(bits.astype(jnp.uint16),
                                        jnp.float16).astype(jnp.float32)


def encode_log_ids(ids):
    """Pixel ids (< 2^23) -> f32 bit patterns for the completion log's
    payload row. Bit 30 keeps every pattern a NORMAL float: raw small ids
    are f32 denormals, which a flush-to-zero backend zeroes inside fused
    copies — and the id is the reassembly key."""
    return jax.lax.bitcast_convert_type(ids | jnp.int32(0x40000000),
                                        jnp.float32)


def decode_log_ids(f):
    """Inverse of :func:`encode_log_ids`."""
    return jax.lax.bitcast_convert_type(f, jnp.int32) & jnp.int32(0x3FFFFFFF)


def _bvh_instances(scene: RenderScene):
    return [i for i, (_, _, c) in enumerate(scene.inst_spans)
            if c > brute_max()]


def _make_parts(scene: RenderScene, B: int, bounces: int, skybox: bool,
                normal_maps: bool = False, nee: bool = False,
                packet: int = 1):
    """Build the shared kernel phases as closures over one (scene, B).

    ``packet`` = P rays per traversal lane (RAY PACKETS): every ROW GATHER
    and all traversal control state (I_CUR / I_PTR / I_SP, the resume
    stack) live at packet granularity (BP = B // P), while rays keep their
    own physics state (M ray + per-ray best, F path state, RNG, shading).
    A packet traverses the UNION of its rays' needs — a wide row is
    entered when ANY live ray hits a child slab (each ray pruned by its
    own best), and each ray tests every fetched leaf against its own
    best. Fetches per ray only go DOWN (a row serves up to P rays where
    scalar lanes would fetch it up to P times); the replay sim on the
    real dragon BVH measured 3.8x fewer fetches on 2x4-pixel primary
    packets and 2.2x on first-bounce packets at P=4
    (scripts/sim_packet.py). P == 1 is the exact original kernel: every
    packet helper below degenerates to identity."""
    from ray_tracer_2_tpu.kernels.trace import (
        _gather_material, _mat4_apply, _reflectance, environment_light,
    )

    bvh_ids = _bvh_instances(scene)
    n_bvh = len(bvh_ids)
    roots = [scene.wide_roots[i] for i in bvh_ids]
    # Sphere BVH (accel/wide.py pack_sphere_wide_rows): one extra traversal
    # phase AFTER the triangle instances (phase index n_bvh), in WORLD space.
    # Replaces the dense every-sphere cross of the prepass — the reference
    # loops all spheres per ray (ray_tracer.wgsl:357-364) and so did we;
    # random_balls pays 484 quadratics x 16k lanes per segment that way.
    sph_root = int(getattr(scene, "sphere_bvh_root", -1))
    sph = sph_root >= 0
    n_phase = n_bvh + (1 if sph else 0)
    # Next-event estimation (needs a non-empty static light table):
    #   mode 1 — no-traversal scenes: the shadow query is ONE extra inline
    #            segment_prepass per boundary (cheapest).
    #   mode 2 — traversal scenes: the shadow query is a SHADOW SEGMENT
    #            through the ordinary prepass+traversal machinery, with the
    #            continuation ray + pending contribution stashed in
    #            F[:, 14:24]. RT2_NEE_SEGMENTS=1 forces mode 2 on
    #            no-traversal scenes too — there both modes are BIT-EQUAL
    #            (tests/test_nee.py), which is the correctness gate for the
    #            stash/bit/bounce plumbing.
    import os as _os
    if nee and len(scene.lights) > 0:
        nee_mode = 2 if (n_phase > 0
                         or _os.environ.get("RT2_NEE_SEGMENTS") == "1") else 1
    else:
        nee_mode = 0
    SPH_SENT = 0x3FFFFFFF  # best-id sentinel: loses every (dst, id) lex tie
    D = int(scene.wide_depth) + 2  # resume-stack depth (static)
    w2m_all = scene.inst_world_to_model
    m2w_all = scene.inst_model_to_world

    # ---- ray-packet helpers (identity at P == 1) ---------------------
    P = packet
    assert B % P == 0, (B, P)
    BP = B // P

    def rep(x):
        """(BP, ...) packet value -> (B, ...) per-ray broadcast."""
        if P == 1:
            return x
        return jnp.broadcast_to(x[:, None], (BP, P) + x.shape[1:]) \
            .reshape((B,) + x.shape[1:])

    def pkt_any(x):
        """(B, ...) per-ray bool -> (BP, ...) any-over-packet."""
        if P == 1:
            return x
        return x.reshape((BP, P) + x.shape[1:]).any(axis=1)

    def pkt_min(x):
        if P == 1:
            return x
        return x.reshape((BP, P) + x.shape[1:]).min(axis=1)

    def pkt_max(x):
        if P == 1:
            return x
        return x.reshape((BP, P) + x.shape[1:]).max(axis=1)

    def _sel4x4(table, ids, ptr):
        out = jnp.broadcast_to(table[ids[0]], (B, 4, 4))
        for k in range(1, len(ids)):
            out = jnp.where((ptr == k)[:, None, None],
                            jnp.broadcast_to(table[ids[k]], (B, 4, 4)), out)
        return out

    def w2m_for(ptr):
        return _sel4x4(w2m_all, bvh_ids, ptr)

    def m2w_for(ptr):
        return _sel4x4(m2w_all, bvh_ids, ptr)

    deltas_bvh = [scene.inst_mat_deltas[i] for i in bvh_ids]

    def delta_for(ptr):
        """Material-id delta for instanced-geometry sharing (0 if none)."""
        if not any(deltas_bvh):
            return jnp.zeros((B,), jnp.int32)
        out = jnp.full((B,), deltas_bvh[0], jnp.int32)
        for j in range(1, n_bvh):
            out = jnp.where(ptr == j, deltas_bvh[j], out)
        return out

    def m2w_raw(raw):
        if scene.n_instances == 0:  # no meshes anywhere: value never used
            return jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32), (B, 4, 4))
        return _sel4x4(m2w_all, list(range(scene.n_instances)), raw)

    # ------------------------------------------------ traversal step --
    # Compact 32-ary wide rows (f16 child boxes, component-blocked) +
    # per-lane (base, hitmask) resume stack (accel/wide.py). Fetch count
    # is the currency: ~9 rows/segment vs 29-34 for the binary skip-link
    # tables (scripts/sim_wide256.py replay).
    from ray_tracer_2_tpu.accel import wide as wd

    stack_cols = jnp.arange(D, dtype=jnp.int32)[None, :]

    # Per-instance ROOT rows are compile-time slices — evaluating the root's
    # child slabs inline at instance/segment entry costs no gather and
    # removes one fetch per (segment x instance): ~10% of all fetches, and
    # 100% for rays that miss the instance box outright.
    if n_bvh:
        root_rows = jnp.stack([scene.wide_rows[r] for r in roots], axis=0)
    if sph:
        sph_root_row = scene.wide_rows[sph_root]

    def root_row_for(ptr):
        """Root row per PACKET (``ptr`` is the (BP,) phase pointer)."""
        out = jnp.broadcast_to(root_rows[0], (BP, 128))
        for j in range(1, n_bvh):
            out = jnp.where((ptr == j)[:, None],
                            jnp.broadcast_to(root_rows[j], (BP, 128)), out)
        return out

    def unpack_child_aabbs(row):
        """(B, 128) f32 row -> ((B, 96) lo, (B, 96) hi) child bounds in the
        COMPONENT-BLOCKED order min_x*32 | min_y*32 | min_z*32 (maxes in
        the high halves) — see accel/wide.py. Blocked order lets the slab
        test run as ~15 wide (B, 32) vector ops instead of 32 narrow
        (B, 3) slices."""
        cols = row[:, wd.COL_CHILD_AABB:wd.COL_CHILD_AABB + wd.N_AABB_COLS]
        u = jax.lax.bitcast_convert_type(cols, jnp.uint32)
        return f16_bits_to_f32(u & 0xFFFF), f16_bits_to_f32(u >> 16)

    A = wd.MAX_ARITY
    child_lane = jnp.arange(A, dtype=jnp.int32)[None, :]

    def slab_blocked(lo, hi, om, inv, limit):
        """(B, 96) blocked bounds -> ((B, 32) hit, (B, 32) t_near); exact
        same arithmetic as kernels/intersect.py:ray_aabb_dist, vectorized
        across children instead of axes."""
        t1x = (lo[:, 0:A] - om[:, 0:1]) * inv[:, 0:1]
        t2x = (hi[:, 0:A] - om[:, 0:1]) * inv[:, 0:1]
        t1y = (lo[:, A:2*A] - om[:, 1:2]) * inv[:, 1:2]
        t2y = (hi[:, A:2*A] - om[:, 1:2]) * inv[:, 1:2]
        t1z = (lo[:, 2*A:3*A] - om[:, 2:3]) * inv[:, 2:3]
        t2z = (hi[:, 2*A:3*A] - om[:, 2:3]) * inv[:, 2:3]
        tn = jnp.maximum(jnp.maximum(jnp.minimum(t1x, t2x),
                                     jnp.minimum(t1y, t2y)),
                         jnp.minimum(t1z, t2z))
        tf = jnp.minimum(jnp.minimum(jnp.maximum(t1x, t2x),
                                     jnp.maximum(t1y, t2y)),
                         jnp.maximum(t1z, t2z))
        hit = (tf >= tn) & (tn < limit[:, None]) & (tf > 0.0)
        return hit, tn

    def wide_eval(row, om, inv_dm, limit, k):
        """Shared wide-row evaluation: (mask, c_min, dn2) with c_min the
        nearest-entry hit child (first index on ties, like argmin) and dn2
        the minimum entry distance over the REMAINING hit children — the
        resume stack stores it for pop-time pruning (a resumed subtree
        whose stored min >= the current best hit cannot contain a closer
        hit; dropping such entries measured -17% primary / -4% bounce
        fetches on the dragon, scripts/sim_popprune.py).

        Packet form: ``row``/``k`` are per PACKET (BP,...), ``om``/
        ``inv_dm``/``limit`` per RAY (B,...); the slab test runs per ray
        and the returned (mask, c_min, dn2) are the UNION over each
        packet's rays (hit = any ray hits; distances = min over rays —
        conservative for pruning, exact for hit/miss)."""
        lo_a, hi_a = unpack_child_aabbs(row)
        hit, tn = slab_blocked(rep(lo_a), rep(hi_a), om, inv_dm, limit)
        hit = hit & (child_lane < rep(k)[:, None])
        dn = jnp.where(hit, tn, INF)
        hit_p = pkt_any(hit)
        dn_p = pkt_min(dn)
        bits = hit_p.astype(jnp.int32) << child_lane
        mask = jnp.sum(bits, axis=1)
        c_min = jnp.argmin(dn_p, axis=1).astype(jnp.int32)
        dn2 = jnp.min(jnp.where(child_lane == c_min[:, None], INF, dn_p),
                      axis=1)
        return mask, c_min, dn2

    def wide_enter(row, om, dm, enter, SB, SM, SD, limit=None):
        """Evaluate a wide row for freshly-entering lanes (t_limit = INF, or
        ``limit`` — the sphere phase enters with the segment's current best
        world distance): nearest-hit child entry + remainder push onto an
        empty stack. Returns (cur — -1 on miss, SB, SM, SD, sp, k).
        Packet form: ``row``/``enter``/stack/cur at (BP,...); ``om``/
        ``dm``/``limit`` per ray."""
        inv_dm = 1.0 / dm
        k = row[:, wd.COL_K].astype(jnp.int32)
        if limit is None:
            limit = jnp.full((B,), INF)
        mask, c_min, dn2 = wide_eval(row, om, inv_dm, limit, k)
        base = row[:, wd.COL_BASE].astype(jnp.int32)
        has = mask != 0   # bit 31 makes int32 masks negative
        rem = mask & ~jnp.left_shift(jnp.int32(1), c_min)
        push = enter & has & (rem != 0)
        at0 = (stack_cols == 0) & push[:, None]
        SB = jnp.where(at0, base[:, None], SB)
        SM = jnp.where(at0, rem[:, None], SM)
        SD = jnp.where(at0, jax.lax.bitcast_convert_type(
            dn2, jnp.int32)[:, None], SD)
        sp = push.astype(jnp.int32)
        cur = jnp.where(has, base + c_min, -1)
        return cur, SB, SM, SD, sp, k

    def traversal_step(F, M, W, I, S):
        cur = I[:, I_CUR]                 # (BP,) packet traversal pointer
        active = cur >= 0                 # (BP,)
        om, dm = M[:, 0:3], M[:, 3:6]     # per-ray model-space ray
        inv_dm = 1.0 / dm
        safe = jnp.where(active, cur, 0)
        row = jnp.take(scene.wide_rows, safe, axis=0)   # (BP, 128)

        best_dst = M[:, 6]                # per-ray pruning limit / best
        count = row[:, wd.COL_COUNT]
        is_leaf = active & (count > 0.5)  # (BP,)
        is_wide = active & (count < 0.5)

        # ---- wide row: test up to 32 child slabs (one blocked vector op
        # batch); enter the NEAREST hit child (packet union), stack the
        # rest as a positional hit mask. Empty slots hold inverted boxes;
        # the c < k gate inside wide_eval is what really excludes them ----
        k = row[:, wd.COL_K].astype(jnp.int32)
        mask, c_min, dn2 = wide_eval(row, om, inv_dm, best_dst, k)
        mask = jnp.where(is_wide, mask, 0)
        base = row[:, wd.COL_BASE].astype(jnp.int32)
        has = mask != 0   # bit 31 makes int32 masks negative
        child = base + c_min
        rem = mask & ~jnp.left_shift(jnp.int32(1), c_min)

        # which lanes are in the sphere-BVH phase (ptr == n_bvh)? STATIC
        # per-scene: pure-sphere scenes compile out the triangle test, tri
        # scenes without a sphere BVH compile out the sphere test.
        if sph:
            sph_phase = active if n_bvh == 0 else \
                (active & (I[:, I_PTR] == n_bvh))      # (BP,)
        omx, omy, omz = om[:, 0:1], om[:, 1:2], om[:, 2:3]
        dmx, dmy, dmz = dm[:, 0:1], dm[:, 1:2], dm[:, 2:3]
        best_u, best_v, best_det = M[:, 7], M[:, 8], M[:, 9]
        best_tri, best_mat = I[:, I_TRI], I[:, I_MAT]   # per-ray winners
        G = wd.COL_LEAF_GEO

        if n_bvh:
            # ---- leaf row: blocked 8-triangle Möller–Trumbore. Geometry is
            # component-blocked with f32-precomputed edges/normals
            # (accel/wide.py), so the whole test is ~45 wide (B, 8) ops —
            # the sequential per-triangle loop of (B, 3) slices was the only
            # step cost not hidden under the row-gather latency
            # (scripts/ablate_step.py) ----
            tri_leaf = rep(is_leaf if not sph else (is_leaf & ~sph_phase))
            first = rep(row[:, wd.COL_FIRST].astype(jnp.int32))
            rw = rep(row)   # (B, 128): leaf geometry expanded to the rays
            v0x, v0y, v0z = rw[:, G:G+8], rw[:, G+8:G+16], \
                rw[:, G+16:G+24]
            e1x, e1y, e1z = rw[:, G+24:G+32], rw[:, G+32:G+40], \
                rw[:, G+40:G+48]
            e2x, e2y, e2z = rw[:, G+48:G+56], rw[:, G+56:G+64], \
                rw[:, G+64:G+72]
            nx_, ny_, nz_ = rw[:, G+72:G+80], rw[:, G+80:G+88], \
                rw[:, G+88:G+96]
            det8 = -(dmx * nx_ + dmy * ny_ + dmz * nz_)
            mc = rw[:, wd.COL_MATCULL:wd.COL_MATCULL + 8].astype(jnp.int32)
            cull8 = (mc & 1) == 1
            keep8 = (cull8 & (det8 >= 1e-8)) | (~cull8 & (jnp.abs(det8) >= 1e-8))
            inv8 = 1.0 / jnp.where(keep8, det8, 1.0)
            aox, aoy, aoz = omx - v0x, omy - v0y, omz - v0z
            daox = aoy * dmz - aoz * dmy
            daoy = aoz * dmx - aox * dmz
            daoz = aox * dmy - aoy * dmx
            dst8 = (aox * nx_ + aoy * ny_ + aoz * nz_) * inv8
            u8 = (e2x * daox + e2y * daoy + e2z * daoz) * inv8
            v8 = -(e1x * daox + e1y * daoy + e1z * daoz) * inv8
            w8 = 1.0 - u8 - v8
            hit8 = keep8 & (dst8 > 1e-5) & (u8 >= 0.0) & (v8 >= 0.0) \
                & (w8 >= 0.0) & tri_leaf[:, None] & (dst8 < best_dst[:, None])
            dstw8 = jnp.where(hit8, dst8, INF)
            jlane = jnp.arange(LEAF_CHUNK, dtype=jnp.int32)[None, :]
            jstar = jnp.argmin(dstw8, axis=1).astype(jnp.int32)
            winner8 = hit8 & (jlane == jstar[:, None])
            m8 = jnp.sum(jnp.where(winner8, dstw8, 0.0), axis=1)
            better = jnp.any(hit8, axis=1)
            best_u = jnp.where(better,
                               jnp.sum(jnp.where(winner8, u8, 0.0),
                                       axis=1), best_u)
            best_v = jnp.where(better,
                               jnp.sum(jnp.where(winner8, v8, 0.0),
                                       axis=1), best_v)
            best_det = jnp.where(better,
                                 jnp.sum(jnp.where(winner8, det8, 0.0),
                                         axis=1), best_det)
            best_mat = jnp.where(better,
                                 jnp.sum(jnp.where(winner8, mc >> 1, 0),
                                         axis=1),
                                 best_mat)
            best_tri = jnp.where(better, first + jstar, best_tri)
            best_dst = jnp.where(better, m8, best_dst)

        if sph:
            # ---- sphere leaf: blocked 8-sphere quadratic, same SOURCE
            # arithmetic as the dense prepass (intersect.ray_sphere) but
            # NOT bit-equal in practice: XLA fuses the (B, 8) blocked and
            # (B, S) dense graphs with different FMA/re-association, and
            # grazing hits (disc ~ 0 on the huge ground sphere) amplify
            # the ulps — measured ~0.6% pixel re-routes on random_balls.
            # Winner rule reproduces the dense path's argmin tie-break
            # (lowest original id among equal distances) via a (dst, id)
            # lexicographic compare, seeded with SPH_SENT so a sphere
            # BEATS an equal-distance triangle/brute hit — the dense order
            # evaluated spheres first and later phases compared strictly. ----
            sph_leaf = rep(is_leaf if n_bvh == 0 else (is_leaf & sph_phase))
            rws = rep(row)
            cx = rws[:, G:G+8]
            cy = rws[:, G+8:G+16]
            cz = rws[:, G+16:G+24]
            r2 = rws[:, G+24:G+32]
            sid = rws[:, wd.COL_SPH_ID:wd.COL_SPH_ID + 8]
            ocx, ocy, ocz = omx - cx, omy - cy, omz - cz
            a1 = dmx * dmx + dmy * dmy + dmz * dmz
            b1 = 2.0 * (ocx * dmx + ocy * dmy + ocz * dmz)
            c1 = (ocx * ocx + ocy * ocy + ocz * ocz) - r2
            disc = b1 * b1 - 4.0 * a1 * c1
            sq = jnp.sqrt(jnp.maximum(disc, 0.0))
            dn8 = jnp.maximum(0.0, (-b1 - sq) / (2.0 * a1))
            df8 = (-b1 + sq) / (2.0 * a1)
            hitS = (disc >= 0.0) & (df8 >= 0.001) & sph_leaf[:, None]
            dstS = jnp.where(dn8 == 0.0, df8, dn8)
            dstwS = jnp.where(hitS, dstS, INF)
            sidw = jnp.where(hitS, sid, jnp.float32(SPH_SENT))
            mnS = jnp.min(dstwS, axis=1)
            idw = jnp.where(dstwS == mnS[:, None], sidw,
                            jnp.float32(SPH_SENT))
            idmn = jnp.min(idw, axis=1)
            anyS = jnp.any(hitS, axis=1)
            best_id_f = best_tri.astype(jnp.float32)
            betterS = anyS & ((mnS < best_dst)
                              | ((mnS == best_dst) & (idmn < best_id_f)))
            best_tri = jnp.where(betterS, idmn.astype(jnp.int32), best_tri)
            best_dst = jnp.where(betterS, mnS, best_dst)

        # ---- stack: push the remaining-hits entry, or pop to resume.
        # Entries carry the min entry distance of their remaining children
        # (stale after partial consumption — conservative): pops jump to
        # the DEEPEST entry still closer than best_dst, bulk-dropping dead
        # entries above it for free ----
        SB, SM, SD = S
        sp = I[:, I_SP]
        push = is_wide & has & (rem != 0)
        at_sp = (stack_cols == sp[:, None]) & push[:, None]
        SB = jnp.where(at_sp, base[:, None], SB)
        SM = jnp.where(at_sp, rem[:, None], SM)
        SD = jnp.where(at_sp, jax.lax.bitcast_convert_type(
            dn2, jnp.int32)[:, None], SD)
        sp = sp + push.astype(jnp.int32)

        finished = active & (is_leaf | (is_wide & ~has))
        SDf = jax.lax.bitcast_convert_type(SD, jnp.float32)
        # pop-time pruning vs the packet's LOOSEST ray (max best): an
        # entry is dead only when NO ray can still find a closer hit there
        best_pkt = pkt_max(best_dst)
        live_e = (stack_cols < sp[:, None]) & (SDf < best_pkt[:, None])
        any_live = jnp.any(live_e, axis=1)
        pstar = jnp.max(jnp.where(live_e, stack_cols, -1), axis=1)
        at_top0 = stack_cols == pstar[:, None]
        top_b = jnp.sum(jnp.where(at_top0, SB, 0), axis=1)
        top_m = jnp.sum(jnp.where(at_top0, SM, 0), axis=1)
        can_pop = finished & any_live
        at_top = stack_cols == pstar[:, None]
        plow = top_m & -top_m
        pchild = top_b + jax.lax.population_count(jnp.maximum(plow - 1, 0))
        prem = top_m ^ plow
        SM = jnp.where(at_top & (can_pop & (prem != 0))[:, None],
                       prem[:, None], SM)
        sp = jnp.where(finished,
                       jnp.where(can_pop, pstar + (prem != 0), 0), sp)

        new_cur = jnp.where(is_wide & has, child,
                            jnp.where(can_pop, pchild,
                                      jnp.where(finished, -1, cur)))

        M = jnp.concatenate([om, dm, best_dst[:, None], best_u[:, None],
                             best_v[:, None], best_det[:, None]], axis=1)
        S = (SB, SM, SD)
        I = I.at[:, I_CUR].set(jnp.where(active, new_cur, cur))
        I = I.at[:, I_SP].set(sp)
        I = I.at[:, I_TRI].set(best_tri)
        I = I.at[:, I_MAT].set(best_mat)
        I = I.at[:, I_SN].add(rep(jnp.where(is_wide, k, 0)))
        I = I.at[:, I_ST].add(rep(jnp.where(is_leaf,
                                            count.astype(jnp.int32), 0)))
        return F, M, W, I, S

    # ------------------------------------ instance advance (inline) --
    def advance_instance(F, M, W, I, S):
        if n_phase == 0:
            return F, M, W, I, S
        # On 1-phase scenes the advance fires most iterations AND the
        # lax.cond is a scheduling barrier (same effect as the boundary
        # gate), so it is inlined. Multi-phase scenes keep the gate — it
        # skips real work there.
        if n_phase <= 2:
            return _advance_impl(F, M, W, I, S)
        cur = I[:, I_CUR]
        ptr = I[:, I_PTR]
        live = pkt_any((I[:, I_BOUNCE] != DONE) & (I[:, I_BOUNCE] != IDLE))
        pending = (cur == -1) & (ptr < n_phase) & live
        return jax.lax.cond(jnp.any(pending), _advance_impl,
                            lambda *s: s, F, M, W, I, S)

    def _sphere_merge(F, M, W, I, at_send):
        """Sphere-phase end: fold the traversal's lex winner (id in I_TRI,
        dst in M[:, 6]) into the segment state. Centre/radius/material come
        from exact one-hot matmuls (HIGHEST) — the same fetch the dense
        prepass used — and the inside flag is recomputed with the identical
        quadratic, so every value is bit-equal to the dense path's."""
        got = rep(at_send) & (I[:, I_TRI] != SPH_SENT)
        Ssp = scene.n_spheres
        sid = jnp.clip(I[:, I_TRI], 0, Ssp - 1)
        oh = (sid[:, None] == jnp.arange(Ssp, dtype=jnp.int32)[None, :]
              ).astype(jnp.float32)
        centre = jnp.dot(oh, scene.sphere_pos,
                         precision=jax.lax.Precision.HIGHEST)
        rad = jnp.dot(oh, scene.sphere_radius,
                      precision=jax.lax.Precision.HIGHEST)
        mat = jnp.dot(oh, scene.sphere_mat.astype(jnp.float32),
                      precision=jax.lax.Precision.HIGHEST).astype(jnp.int32)
        o, d = F[:, 0:3], F[:, 3:6]
        dst = M[:, 6]
        hp = o + d * dst[:, None]
        oc = o - centre
        a1 = dot(d, d)
        b1 = 2.0 * dot(oc, d)
        c1 = dot(oc, oc) - rad * rad
        disc = b1 * b1 - 4.0 * a1 * c1
        sq = jnp.sqrt(jnp.maximum(disc, 0.0))
        inside = jnp.maximum(0.0, (-b1 - sq) / (2.0 * a1)) == 0.0
        sn, s_uv = sphere_normal_uv(hp, centre, inside)
        W = jnp.where(got[:, None], jnp.concatenate([
            dst[:, None], jnp.zeros((B, 3)), hp, sn, s_uv], axis=1), W)
        I = I.at[:, I_STRI].set(jnp.where(got, -2, I[:, I_STRI]))
        I = I.at[:, I_SMAT].set(jnp.where(got, mat, I[:, I_SMAT]))
        I = I.at[:, I_FLAG].set(jnp.where(got, inside.astype(jnp.int32),
                                          I[:, I_FLAG]))
        return W, I

    def _advance_impl(F, M, W, I, S):
        cur = I[:, I_CUR]                 # (BP,)
        ptr = I[:, I_PTR]                 # (BP,)
        live = pkt_any((I[:, I_BOUNCE] != DONE) & (I[:, I_BOUNCE] != IDLE))
        o = F[:, 0:3]

        if sph:
            at_send = (cur == -1) & (ptr == n_bvh) & live
            W, I = _sphere_merge(F, M, W, I, at_send)

        if n_bvh == 0:
            # sphere phase only: merge done, move to the boundary
            I = I.at[:, I_PTR].set(jnp.where(
                (cur == -1) & (ptr == 0) & live, 1, ptr))
            return F, M, W, I, S

        at_end = (cur == -1) & (ptr < n_bvh) & live      # (BP,)
        at_end_r = rep(at_end)
        om, dm = M[:, 0:3], M[:, 3:6]
        got = at_end_r & (I[:, I_TRI] >= 0)              # per-ray merge
        m2w = m2w_for(rep(ptr))
        local_hp = om + dm * M[:, 6:7]
        world_hp = _matvec(m2w[:, :3, :3], local_hp) + m2w[:, :3, 3]
        world_dst = jnp.sqrt(dot(world_hp - o, world_hp - o))
        better = got & (world_dst < W[:, 0])
        W = jnp.where(better[:, None], jnp.concatenate([
            world_dst[:, None], M[:, 7:10], world_hp, jnp.zeros((B, 5))],
            axis=1), W)
        I = I.at[:, I_STRI].set(jnp.where(better, I[:, I_TRI], I[:, I_STRI]))
        I = I.at[:, I_SMAT].set(jnp.where(better,
                                          I[:, I_MAT] + delta_for(rep(ptr)),
                                          I[:, I_SMAT]))
        # static where-chain, not a take: a (B,)-indexed take is a per-lane
        # scalar gather even on a tiny table
        raw = jnp.full((B,), bvh_ids[0], jnp.int32)
        for j in range(1, n_bvh):
            raw = jnp.where(rep(ptr) == j, jnp.int32(bvh_ids[j]), raw)
        I = I.at[:, I_FLAG].set(jnp.where(better, raw, I[:, I_FLAG]))

        new_ptr = jnp.where(at_end, ptr + 1, ptr)
        if sph:
            new_ptr = jnp.where((cur == -1) & (ptr == n_bvh) & live,
                                n_bvh + 1, new_ptr)
        SB, SM, SD = S
        if n_bvh > 1:
            entering = at_end & (new_ptr < n_bvh)        # (BP,)
            entering_r = rep(entering)
            w2m = w2m_for(rep(new_ptr))
            d = F[:, 3:6]
            om_n = _matvec(w2m[:, :3, :3], o) + w2m[:, :3, 3]
            dm_n = normalize(_matvec(w2m[:, :3, :3], d))
            # Seed the pruning limit from the best WORLD hit so far (prepass
            # + earlier instances): same exact distance mapping + ulp slack
            # as start_segments. Cuts the second instance's traversal on
            # room2-class scenes wherever the first already found a closer
            # hit.
            m2w_n = m2w_for(rep(new_ptr))
            wv_n = _matvec(m2w_n[:, :3, :3], dm_n)
            slack_e = 8e-6 * (1.0 + jnp.sqrt(dot(o, o)))
            limit_e = (W[:, 0] * (1.0 + 4e-6) + slack_e) \
                / jnp.sqrt(dot(wv_n, wv_n))
            if P > 1:
                # inert rays (M best pinned at -INF by start_segments) stay
                # inert across instance entries
                limit_e = jnp.where(M[:, 6] <= jnp.float32(-INF),
                                    jnp.float32(-INF), limit_e)
            M = jnp.where(entering_r[:, None], jnp.concatenate(
                [om_n, dm_n, limit_e[:, None], jnp.zeros((B, 3))],
                axis=1), M)
            # inline root evaluation: entering lanes land directly on the
            # root's nearest hit child (or -1 on a whole-instance miss) with
            # the remaining hits pre-pushed — no root row gather
            cur_e, SB, SM, SD, sp_e, k_e = wide_enter(
                root_row_for(new_ptr), om_n, dm_n, entering, SB, SM, SD,
                limit=limit_e)
            I = I.at[:, I_CUR].set(jnp.where(entering, cur_e, I[:, I_CUR]))
            I = I.at[:, I_TRI].set(jnp.where(entering_r, -1, I[:, I_TRI]))
            I = I.at[:, I_SP].set(jnp.where(entering, sp_e, I[:, I_SP]))
            I = I.at[:, I_SN].add(rep(jnp.where(entering, k_e, 0)))
        # else: the tri entering block is logically dead on 1-instance
        # scenes (new_ptr always reaches n_bvh), so it is compiled out.
        if sph:
            # lanes that just finished the LAST triangle instance enter the
            # sphere BVH (world space, seeded with the segment's best world
            # distance for slab pruning + the lex-tie seed)
            entering_s = at_end & (new_ptr == n_bvh)     # (BP,)
            d = F[:, 3:6]
            limit_s = W[:, 0]
            if P > 1:
                limit_s = jnp.where(M[:, 6] <= jnp.float32(-INF),
                                    jnp.float32(-INF), limit_s)
            M = jnp.where(rep(entering_s)[:, None], jnp.concatenate(
                [o, d, limit_s[:, None], jnp.zeros((B, 3))], axis=1), M)
            cur_s, SB, SM, SD, sp_s, k_s = wide_enter(
                jnp.broadcast_to(sph_root_row, (BP, 128)), o, d, entering_s,
                SB, SM, SD, limit=limit_s)
            I = I.at[:, I_CUR].set(jnp.where(entering_s, cur_s, I[:, I_CUR]))
            I = I.at[:, I_TRI].set(jnp.where(rep(entering_s), SPH_SENT,
                                             I[:, I_TRI]))
            I = I.at[:, I_SP].set(jnp.where(entering_s, sp_s, I[:, I_SP]))
            I = I.at[:, I_SN].add(rep(jnp.where(entering_s, k_s, 0)))
        S = (SB, SM, SD)
        I = I.at[:, I_PTR].set(new_ptr)
        return F, M, W, I, S

    # -------------------------------------------- resolve + shade ----
    def resolve_and_shade(F, W, I, at_b):
        """Shading for rays at a boundary with a completed segment. Returns
        (o, d, trans, incoming, seed, continues_path, nee_bit) —
        continues_path means the path survives into another segment;
        nee_bit (None unless NEE is compiled in) marks lanes whose bounce
        just sampled a light directly, so the NEXT hit's surface emission
        must be skipped."""
        o, d = F[:, 0:3], F[:, 3:6]
        trans, incoming = F[:, 6:10], F[:, 10:14]
        seed = jax.lax.bitcast_convert_type(I[:, I_SEED], jnp.uint32)
        bounce = I[:, I_BOUNCE]
        started = bounce >= 0

        seg_tri = I[:, I_STRI]
        hit_mesh = seg_tri >= 0
        attr = fetch_attr(scene.tri_attr, jnp.maximum(seg_tri, 0))
        m2w = m2w_raw(jnp.clip(I[:, I_FLAG], 0, scene.n_instances - 1))
        u, v, det = W[:, 1], W[:, 2], W[:, 3]
        w_bar = 1.0 - u - v
        n_model = normalize(attr[:, 0:3] * w_bar[:, None]
                            + attr[:, 3:6] * u[:, None]
                            + attr[:, 6:9] * v[:, None]) * jnp.sign(det)[:, None]
        n_world = normalize(_matvec(m2w[:, :3, :3], n_model))
        uv_mesh = (attr[:, 9:11] * w_bar[:, None] + attr[:, 11:13] * u[:, None]
                   + attr[:, 13:15] * v[:, None])

        sphere_won = seg_tri == -2
        hit = dict(
            hit=(hit_mesh | sphere_won) & started & at_b,
            dst=W[:, 0],
            point=W[:, 4:7],
            normal=jnp.where(sphere_won[:, None], W[:, 7:10], n_world),
            uv=jnp.where(sphere_won[:, None], W[:, 10:12], uv_mesh),
            backface=jnp.where(sphere_won, I[:, I_FLAG] > 0, det < 0.0),
            mat_id=I[:, I_SMAT],
        )

        alive = at_b & started & (bounce <= bounces)
        if nee_mode == 2:
            # lanes resuming from a SHADOW segment are not at a path
            # vertex: no sky light, no shading, no RNG consumption (their
            # seed must stay exactly where the diffuse bounce left it)
            in_shadow = (I[:, I_NEE] & 2) != 0
            alive = alive & ~in_shadow
        missed = alive & ~hit["hit"]
        if skybox:
            incoming = jnp.where(missed[:, None],
                                 incoming + trans * environment_light(d),
                                 incoming)
        shading = alive & hit["hit"]

        # STATIC specialization (scene.shade_classes): branches a scene can
        # never take are compiled out entirely — the dragon has no glass, so
        # its boundary phase carries no refract/Schlick/Beer-Lambert code.
        # RNG parity is preserved: the glass draw chain forks from the same
        # seed as the non-glass chain and non-glass lanes never read it.
        has_glass = "glass" in scene.shade_classes
        has_texture = "texture" in scene.shade_classes
        tex_dominant = "texture_dominant" in scene.shade_classes

        m = _gather_material(scene, hit["mat_id"])
        is_glass = (m["flag"] == GLASS) if has_glass \
            else jnp.zeros((B,), bool)
        normal = hit["normal"]
        backface = hit["backface"]

        if normal_maps and "normal_map" in scene.shade_classes:
            # Tangent-frame normal mapping — the reference stubbed this out
            # (ray_tracer.wgsl:440-447). Mesh hits only (spheres carry no
            # tangent frame); the sampled map is decoded as 2n-1 and rotated
            # into world space through the per-triangle TBN (accel/packed.py
            # pack_tri_attributes cols 15:19).
            has_nm = shading & hit_mesh & (m["normal_index"] != -1)
            texel = jax.lax.cond(
                jnp.any(has_nm),
                lambda: sample_texture(scene, m["normal_index"], hit["uv"]),
                lambda: jnp.zeros((B, 4)))
            nt = texel[:, :3] * 2.0 - 1.0
            t_model = attr[:, 15:18]
            hand = attr[:, 18:19]
            t_w = normalize(_matvec(m2w[:, :3, :3], t_model))
            t_w = normalize(t_w - normal * dot(t_w, normal, keepdims=True))
            b_w = jnp.cross(normal, t_w) * hand
            n_pert = normalize(t_w * nt[:, 0:1] + b_w * nt[:, 1:2]
                               + normal * nt[:, 2:3])
            normal = jnp.where(has_nm[:, None], n_pert, normal)

        if has_glass:
            absorb = jnp.exp(-hit["dst"][:, None] * m["absorption"][:, :3]
                             * m["absorption_strength"][:, None])
            trans_g = jnp.where((is_glass & backface)[:, None],
                                jnp.concatenate([trans[:, :3] * absorb,
                                                 jnp.ones((B, 1))], axis=1),
                                trans)
            ior = jnp.where(backface, m["ior"], 1.0 / m["ior"])
            reflect_dir = reflect(d, normal)
            refract_dir = refract(d, normal, ior[:, None])
            cos_theta = jnp.minimum(dot(-d, normal), 1.0)
            sin_theta = jnp.sqrt(jnp.maximum(1.0 - cos_theta * cos_theta, 0.0))
            cannot_refract = ior * sin_theta > 1.0
            r_refl, seed_refl = rng.rand(seed)
            seed_g = jnp.where(cannot_refract, seed, seed_refl)
            follow_reflection = cannot_refract | (_reflectance(cos_theta, ior)
                                                  > r_refl)
            rand_dir_g, seed_g = rng.rand_direction(seed_g)
            diffuse_g = normalize(normal + rand_dir_g)
            reflect_mix = normalize(lerp(diffuse_g, reflect_dir,
                                         m["specular"][:, None]))
            refract_mix = normalize(lerp(-diffuse_g, refract_dir,
                                         m["smoothness"][:, None]))
            dir_g = jnp.where(follow_reflection[:, None], reflect_mix,
                              refract_mix)
            origin_g = hit["point"] + 1e-4 * normal \
                * jnp.sign(dot(normal, dir_g))[:, None]

        r_spec, seed_n = rng.rand(seed)
        is_specular = m["specular"] >= r_spec
        diffuse_n, seed_n = rng.rand_hemisphere(normal, seed_n)
        specular_dir = reflect(d, normal)
        emitted = m["emission_color"] * m["emission_strength"][:, None]
        if nee_mode:
            # the previous bounce already accounted this surface's direct
            # light by sampling it (NEE); adding the emission again on a
            # BSDF hit would double count (diffuse bounces only — specular
            # and glass bounces keep emission and never set the bit)
            emitted = jnp.where(((I[:, I_NEE] & 1) > 0)[:, None], 0.0,
                                emitted)
        dir_n = normalize(lerp(diffuse_n, specular_dir,
                               (m["smoothness"] * is_specular)[:, None]))
        incoming_n = incoming + emitted * trans
        if has_texture:
            textured = (m["flag"] == TEXTURE) & (m["diffuse_index"] != -1)
            if tex_dominant:
                # most materials are textured (e.g. sponza): the any()
                # gate would fire every boundary anyway, and the lax.cond
                # is a scheduling barrier keeping the 4 bilinear taps off
                # the overlapped gather schedule
                tex_color = sample_texture(scene, m["diffuse_index"], hit["uv"])
            else:
                # textures are rare: skip the 4-tap gather entirely when
                # no lane shades a textured surface this boundary
                tex_color = jax.lax.cond(
                    jnp.any(textured & shading),
                    lambda: sample_texture(scene, m["diffuse_index"], hit["uv"]),
                    lambda: m["color"])
            color = jnp.where(textured[:, None], tex_color, m["color"])
        else:
            color = m["color"]

        nee_state = None   # new I_NEE bitfield (bit0 suppress-next-emission,
        nee_stash = None   # bit1 in-shadow-segment, bit2 stash-continues)
        if nee_mode:
            # ---- next-event estimation (diffuse bounces) -------------
            # One light sample per diffuse bounce, picked uniformly by
            # area over the static light table. The reference's diffuse
            # bounce is a UNIFORM-hemisphere draw (rand_hemisphere =
            # sign-flipped uniform sphere, ray_tracer.wgsl:176-179) that
            # collects albedo * Le on a light hit — i.e. direction pdf
            # 1/(2pi) with NO cosine factor (not Lambertian-cosine; a
            # cos/pi estimator here measured +8% bright on Cornell). The
            # matching area-form estimator is therefore
            #   albedo * Le * cos_light * total_area / (2 pi d^2)
            # restricted to the upper hemisphere (cos_surf > 0 — the only
            # directions the uniform draw can reach). SINGLE-SIDED lights,
            # matching the reference's backface cull (ray_tracer.wgsl:268,
            # 358 — a light's back side is invisible to BSDF rays; |cos_l|
            # measured +9% bright on Cornell from pixels behind the quad).
            # Occlusion: nee_mode 1 (no-traversal scenes) answers it with
            # one inline prepass; nee_mode 2 defers it to a SHADOW SEGMENT
            # through the ordinary traversal machinery (bit-equal to mode
            # 1 on no-traversal scenes, tests/test_nee.py).
            import numpy as _np
            arr = _np.asarray(scene.lights, _np.float32)
            lk, lv0 = arr[:, 0], arr[:, 1:4]
            lv1, lv2, lrad = arr[:, 4:7], arr[:, 7:10], arr[:, 10:13]
            larea = arr[:, 13]
            nrm = _np.cross(lv1 - lv0, lv2 - lv0)
            nl = _np.linalg.norm(nrm, axis=1, keepdims=True)
            nrm = nrm / _np.maximum(nl, 1e-30)
            tbl = jnp.asarray(_np.concatenate(
                [lk[:, None], lv0, lv1, lv2, nrm, lrad], axis=1))
            total_area = float(larea.sum())
            cdf = _np.cumsum(larea) / max(total_area, 1e-30)
            nL = len(arr)

            r_pick, seed_n = rng.rand(seed_n)
            r1, seed_n = rng.rand(seed_n)
            r2, seed_n = rng.rand(seed_n)
            if nL > 1:
                idx = jnp.sum((r_pick[:, None]
                               >= jnp.asarray(cdf[:-1])[None, :]
                               ).astype(jnp.int32), axis=1)
            else:
                idx = jnp.zeros((B,), jnp.int32)
            onehot = (jnp.arange(nL, dtype=jnp.int32)[None, :]
                      == idx[:, None]).astype(jnp.float32)
            row = jnp.dot(onehot, tbl, precision=jax.lax.Precision.HIGHEST)
            is_sph = row[:, 0] > 0.5
            is_sph_l = is_sph[:, None]
            # triangle: uniform barycentric (sqrt warp); estimator
            # cos_l * A_total / (2 pi d^2), single-sided per the winding
            su = jnp.sqrt(r1)
            p_tri = (row[:, 1:4] * (1.0 - su)[:, None]
                     + row[:, 4:7] * (su * (1.0 - r2))[:, None]
                     + row[:, 7:10] * (su * r2)[:, None])
            dvec = p_tri - hit["point"]
            d2 = dot(dvec, dvec)
            t_tri = jnp.sqrt(jnp.maximum(d2, 1e-12))
            d_tri = dvec / t_tri[:, None]
            cos_l = -dot(row[:, 10:13], d_tri)
            geom_tri = cos_l * (total_area / (2.0 * math.pi)) \
                / jnp.maximum(d2, 1e-12)
            # sphere: CONE sampling toward the subtended solid angle. With
            # the uniform-hemisphere BRDF convention the unoccluded
            # estimator is exactly albedo * Le * (1 - cos_max) (times the
            # area-pick compensation A_total / 4 pi r^2) — zero magnitude
            # variance, and no wasted back-side draws (uniform-AREA
            # sampling measured NOISIER than plain path tracing on the
            # balls scene's huge sun, scripts/validate_nee.py).
            radius_l = row[:, 4]        # sphere rows carry radius in v1.x
            cvec = row[:, 1:4] - hit["point"]
            cd2 = jnp.maximum(dot(cvec, cvec), 1e-12)
            cdist = jnp.sqrt(cd2)
            w_ax = cvec / cdist[:, None]
            sin_max = jnp.clip(radius_l / cdist, 0.0, 1.0)
            cos_max = jnp.sqrt(jnp.maximum(1.0 - sin_max * sin_max, 0.0))
            cos_t = 1.0 - r1 * (1.0 - cos_max)
            sin_t = jnp.sqrt(jnp.maximum(1.0 - cos_t * cos_t, 0.0))
            phi = (2.0 * math.pi) * r2
            helper = jnp.where((jnp.abs(w_ax[:, 0]) > 0.9)[:, None],
                               jnp.asarray([0.0, 1.0, 0.0])[None, :],
                               jnp.asarray([1.0, 0.0, 0.0])[None, :])
            u_b = normalize(jnp.cross(helper, w_ax))
            v_b = jnp.cross(w_ax, u_b)
            d_sph = normalize(w_ax * cos_t[:, None]
                              + (u_b * jnp.cos(phi)[:, None]
                                 + v_b * jnp.sin(phi)[:, None])
                              * sin_t[:, None])
            h_q = dot(d_sph, cvec)
            disc = jnp.maximum(h_q * h_q - (cd2 - radius_l * radius_l), 0.0)
            t_sph = h_q - jnp.sqrt(disc)
            geom_sph = (1.0 - cos_max) * total_area \
                / jnp.maximum(4.0 * math.pi * radius_l * radius_l, 1e-12)
            # a vertex INSIDE an emissive sphere cannot be cone-sampled:
            # skip the sample AND the emission suppression for it (the
            # BSDF path keeps collecting that light)
            sph_valid = cdist > radius_l * 1.001

            d_s = jnp.where(is_sph_l, d_sph, d_tri)
            t_l = jnp.where(is_sph, t_sph, t_tri)
            cos_s = dot(normal, d_s)
            geom = jnp.where(is_sph, geom_sph, geom_tri)
            # the light sample substitutes the NEXT segment's direct hit, so
            # it must respect the same bounce budget — otherwise NEE adds a
            # bounce of direct light a finite-bounce path can never collect
            # (measured +11% mean at bounces=4 on Cornell before this gate)
            diffuse_lane = shading & ~is_specular & ~is_glass \
                & (bounce + 1 <= bounces)
            samplable = jnp.where(is_sph, sph_valid, cos_l > 0.0)
            diffuse_lane = diffuse_lane & (~is_sph | sph_valid)
            potential = diffuse_lane & (cos_s > 0.0) & samplable
            contrib3 = (trans * color)[:, :3] * row[:, 13:16] * geom[:, None]
            if nee_mode == 1:
                W_s, _, _, _, _ = segment_prepass(hit["point"], d_s)
                unocc = W_s[:, 0] >= t_l * (1.0 - 1e-3)
                ok = potential & unocc
                incoming_n = incoming_n + jnp.concatenate(
                    [jnp.where(ok[:, None], contrib3, 0.0),
                     jnp.zeros((B, 1))], axis=1)
                nee_state = diffuse_lane.astype(jnp.int32)   # bit0 only

        trans_n = trans * jnp.where(is_specular[:, None],
                                    m["specular_color"], color)

        if has_glass:
            g = is_glass[:, None]
            new_dir = jnp.where(g, dir_g, dir_n)
            new_origin = jnp.where(g, origin_g, hit["point"])
            new_trans = jnp.where(g, trans_g, trans_n)
            new_incoming = jnp.where(g | ~shading[:, None],
                                     incoming, incoming_n)
            new_seed = jnp.where(is_glass, seed_g, seed_n)
        else:
            new_dir = dir_n
            new_origin = hit["point"]
            new_trans = trans_n
            new_incoming = jnp.where(~shading[:, None], incoming, incoming_n)
            new_seed = seed_n

        p = jnp.max(new_trans[:, :3], axis=1)
        r_rr, new_seed = rng.rand(new_seed)
        survive = r_rr < p
        new_trans = new_trans / jnp.where(p > 0.0, p, 1.0)[:, None]

        live = shading[:, None]
        o = jnp.where(live, new_origin, o)
        d = jnp.where(live, new_dir, d)
        trans = jnp.where(live, new_trans, trans)
        incoming = jnp.where(at_b[:, None] & started[:, None],
                             new_incoming, incoming)
        seed = jnp.where(shading, new_seed, seed)

        next_bounce = bounce + 1
        continues_path = at_b & started & shading & survive \
            & (next_bounce <= bounces)

        if nee_mode == 2:
            # ---- shadow segments through the ordinary machinery -------
            # A shadow ray IS a segment: the diffuse bounce redirects the
            # lane onto (hit_point -> light sample) with the continuation
            # ray + pending contribution stashed in F[:, 14:24]; the next
            # boundary (shadow RESUME) answers occlusion from the
            # segment's own best distance, banks the contribution, and
            # restores the stashed ray. bounce does not advance across the
            # shadow leg (the boundary pins it via bit1).
            cont_o, cont_d = o, d          # the bounce ray (stash source)
            resume = at_b & in_shadow
            t_prev = F[:, 23]
            unocc_r = W[:, 0] >= t_prev * (1.0 - 1e-3)
            incoming = incoming + jnp.concatenate(
                [jnp.where((resume & unocc_r)[:, None], F[:, 20:23], 0.0),
                 jnp.zeros((B, 1))], axis=1)
            o = jnp.where(resume[:, None], F[:, 14:17], o)
            d = jnp.where(resume[:, None], F[:, 17:20], d)
            resume_cont = resume & ((I[:, I_NEE] & 4) != 0)

            start_shadow = potential   # ⊆ shading ⊆ ~in_shadow
            cont_bit = continues_path  # the path decision, stashed as bit2
            o = jnp.where(start_shadow[:, None], hit["point"], o)
            d = jnp.where(start_shadow[:, None], d_s, d)
            nee_stash = jnp.where(
                start_shadow[:, None],
                jnp.concatenate([cont_o, cont_d, contrib3, t_l[:, None]],
                                axis=1),
                F[:, 14:24])
            continues_path = jnp.where(
                start_shadow, True,
                jnp.where(resume, resume_cont, continues_path))
            st = jnp.where(at_b & started, 0, I[:, I_NEE])
            st = jnp.where(diffuse_lane, 1, st)   # suppress-next armed
            st = jnp.where(start_shadow,
                           3 + 4 * cont_bit.astype(jnp.int32), st)
            st = jnp.where(resume, 1, st)
            nee_state = st

        return (o, d, trans, incoming, seed, continues_path, nee_state,
                nee_stash)

    # ---------------------------------------- segment prepass --------
    def segment_prepass(o, d):
        """Spheres + brute-force instances for a new segment with ray (o, d).
        Returns (W_new, M_new, seg_tri, seg_mat, seg_flag)."""
        seg_dst = jnp.full((B,), INF)
        seg_tri2 = jnp.full((B,), -1, jnp.int32)
        seg_mat2 = jnp.zeros((B,), jnp.int32)
        seg_flag2 = jnp.zeros((B,), jnp.int32)
        seg_point = jnp.zeros((B, 3))
        seg_norm = jnp.zeros((B, 3))
        seg_uv = jnp.zeros((B, 2))
        seg_u = jnp.zeros((B,))
        seg_v = jnp.zeros((B,))
        seg_det = jnp.zeros((B,))
        seg_inst = jnp.zeros((B,), jnp.int32)

        if scene.n_spheres > 0 and not sph:
            S = scene.n_spheres
            if S >= _sphere_fast_min():
                # shared-term restructure: no (B, S, 3) intermediates, no
                # (B, S) divides (kernels/intersect.py ray_sphere_fast).
                # Ulp-level reassociation vs ray_sphere — grazing-hit
                # pixel re-routes only (tests/test_sphere_fast.py)
                s_hit, s_dst, s_inside = ray_sphere_fast(
                    o, d, scene.sphere_pos, scene.sphere_radius)
                # LEAN winner extraction: the reference path below runs ~6
                # masked (B, S) reductions; here the winner distance IS the
                # min (dst==INF on miss ⇒ won == sd<INF), centre/radius/mat
                # come from ONE exact one-hot matmul, and `inside` is
                # recomputed (B,)-wide with the pass's exact op order (so
                # the df/dn selection it reflects is bit-identical)
                sidx = jnp.argmin(s_dst, axis=1)
                sd = jnp.min(s_dst, axis=1)
                won = sd < INF
                is_winf = (jnp.arange(S, dtype=jnp.int32)[None, :]
                           == sidx[:, None]).astype(jnp.float32)
                tbl = jnp.concatenate(
                    [scene.sphere_pos, scene.sphere_radius[:, None],
                     scene.sphere_mat.astype(jnp.float32)[:, None]], axis=1)
                fw = jnp.dot(is_winf, tbl,
                             precision=jax.lax.Precision.HIGHEST)
                centre = fw[:, 0:3]
                rad_w = fw[:, 3]
                smat = fw[:, 4].astype(jnp.int32)
                ck = dot(centre, centre) - rad_w * rad_w
                a_r = dot(d, d)
                h = dot(o, d) - (d[:, 0] * centre[:, 0]
                                 + d[:, 1] * centre[:, 1]
                                 + d[:, 2] * centre[:, 2])
                cq = dot(o, o) - 2.0 * (o[:, 0] * centre[:, 0]
                                        + o[:, 1] * centre[:, 1]
                                        + o[:, 2] * centre[:, 2]) + ck
                sq2 = jnp.sqrt(jnp.maximum(h * h - a_r * cq, 0.0))
                inside = jnp.maximum(0.0, (-h - sq2) * (1.0 / a_r)) == 0.0
            else:
                s_hit, s_dst, s_inside = ray_sphere(
                    o[:, None, :], d[:, None, :],
                    scene.sphere_pos[None, :, :],
                    scene.sphere_radius[None, :])
                sidx = jnp.argmin(s_dst, axis=1)
                is_win = jnp.arange(S, dtype=jnp.int32)[None, :] \
                    == sidx[:, None]
                sd = jnp.sum(jnp.where(is_win, s_dst, 0.0), axis=1)
                inside = jnp.any(is_win & s_inside, axis=1)
                won = jnp.any(is_win & s_hit, axis=1)
                smat = jnp.sum(jnp.where(is_win,
                                         scene.sphere_mat[None, :],
                                         0), axis=1)
                centre = jnp.dot(is_win.astype(jnp.float32),
                                 scene.sphere_pos,
                                 precision=jax.lax.Precision.HIGHEST)
            hp = o + d * sd[:, None]
            sn, s_uv = sphere_normal_uv(hp, centre, inside)
            better = won & (sd < seg_dst)
            seg_dst = jnp.where(better, sd, seg_dst)
            seg_tri2 = jnp.where(better, -2, seg_tri2)
            seg_mat2 = jnp.where(better, smat, seg_mat2)
            seg_flag2 = jnp.where(better, inside.astype(jnp.int32), seg_flag2)
            seg_point = jnp.where(better[:, None], hp, seg_point)
            seg_norm = jnp.where(better[:, None], sn, seg_norm)
            seg_uv = jnp.where(better[:, None], s_uv, seg_uv)

        for i, (node_off, tri_off, tri_count) in enumerate(scene.inst_spans):
            if tri_count > brute_max():
                continue
            w2m_i = scene.inst_world_to_model[i]
            m2w_i = scene.inst_model_to_world[i]
            o_m = _mat4_apply(w2m_i, o, 1)
            d_m = normalize(_mat4_apply(w2m_i, d, 0))
            res = brute_force_intersect(scene, o_m, d_m, tri_off, tri_count)
            got = res["tri"] >= 0
            local_hp = o_m + d_m * res["dst"][:, None]
            world_hp = _mat4_apply(m2w_i, local_hp, 1)
            wd = jnp.sqrt(dot(world_hp - o, world_hp - o))
            better = got & (wd < seg_dst)
            seg_dst = jnp.where(better, wd, seg_dst)
            seg_tri2 = jnp.where(better, res["tri"], seg_tri2)
            seg_mat2 = jnp.where(better,
                                 res["mat"] + scene.inst_mat_deltas[i],
                                 seg_mat2)
            seg_u = jnp.where(better, res["u"], seg_u)
            seg_v = jnp.where(better, res["v"], seg_v)
            seg_det = jnp.where(better, res["det"], seg_det)
            seg_point = jnp.where(better[:, None], world_hp, seg_point)
            seg_inst = jnp.where(better, i, seg_inst)

        W_new = jnp.concatenate([
            seg_dst[:, None], seg_u[:, None], seg_v[:, None],
            seg_det[:, None], seg_point, seg_norm, seg_uv], axis=1)
        seg_flag = jnp.where(seg_tri2 == -2, seg_flag2, seg_inst)

        if n_bvh:
            w2m0 = scene.inst_world_to_model[bvh_ids[0]]
            om0 = _mat4_apply(w2m0, o, 1)
            dm0 = normalize(_mat4_apply(w2m0, d, 0))
            M_new = jnp.concatenate([om0, dm0, jnp.full((B, 1), INF),
                                     jnp.zeros((B, 3))], axis=1)
        else:
            M_new = jnp.concatenate([jnp.ones((B, 6)), jnp.full((B, 1), INF),
                                     jnp.zeros((B, 3))], axis=1)
        return W_new, M_new, seg_tri2, seg_mat2, seg_flag

    def start_segments(F, M, W, I, S, starts, o, d, trans, incoming, seed,
                       new_bounce):
        """Apply the prepass + per-segment state reset for rays in ``starts``
        (their new ray is (o, d)). Instance 0's root is evaluated inline
        (wide_enter) — no root-row gather."""
        W_new, M_new, seg_tri2, seg_mat2, seg_flag = segment_prepass(o, d)
        sb = starts[:, None]
        # Packet bookkeeping: the traversal (CUR/PTR/SP/stack) starts when
        # ANY ray of the packet starts a segment. Rays of a starting packet
        # that do NOT start (dead, or log-cap deferred awaiting replay) ride
        # along INERT: their pruning limit is -INF (no slab/leaf/sphere
        # contribution to the union or to their own state) and their
        # traversal scratch I_TRI is reset so advance_instance's merge
        # cannot fire for them. P == 1: starts_pkt == starts, inert == [].
        starts_pkt = pkt_any(starts)
        inert = rep(starts_pkt) & ~starts
        NINF = jnp.float32(-INF)
        # F[:, 14:] (the nee_mode-2 shadow stash, width 0 otherwise) is
        # carried through untouched; the boundary overwrites it afterwards
        F = jnp.concatenate([o, d, trans, incoming, F[:, 14:]], axis=1)
        if not n_bvh and not sph:
            # bvh/sph branches below write their own (limit-seeded) M
            M = jnp.where(sb, M_new, M)
        W = jnp.where(sb, W_new, W)
        I = I.at[:, I_SEED].set(jax.lax.bitcast_convert_type(seed, jnp.int32))
        I = I.at[:, I_BOUNCE].set(jnp.where(starts, new_bounce, I[:, I_BOUNCE]))
        I = I.at[:, I_SEGS].add(starts.astype(jnp.int32))
        # Dead-traversal FAST-FORWARD: when the inline root evaluation hits
        # nothing (cur0 == -1 ⇒ nothing pushed either), the segment's whole
        # BVH phase is already over — jump I_PTR straight to n_phase so the
        # NEXT boundary can resolve this lane, instead of making it idle
        # through a full traversal window + advance_instance first. On the
        # dragon frame ~95% of segments never touch the tree (sky + ground-
        # sphere prepass hits), so this doubles the boundary retire rate.
        # Only exact for single-phase scenes: with a sphere phase after the
        # tri phase (or >1 instance) the advance chain must still run.
        ffwd = (n_bvh == 1 and not sph) or (n_bvh == 0 and sph)
        if n_bvh:
            # Seed the traversal's model-space pruning limit from the
            # prepass best WORLD distance: a model-space distance t_m maps
            # to world distance t_m * |m2w . d_m| exactly (affine), so
            # t_limit = w_best / |m2w . d_m|. A tri hit beyond the sphere/
            # brute hit can never win the world-distance merge
            # (advance_instance ``wd < W[:,0]`` is strict), so pruning at
            # the exact limit is bit-exact — it culls whole traversals for
            # ground-sphere rays (the fast-forward below then retires them
            # at the next boundary) and tightens pop-time pruning for the
            # rest.
            m2w0 = scene.inst_model_to_world[bvh_ids[0]]
            d_m0 = M_new[:, 3:6]
            wv = jnp.dot(d_m0, m2w0[:3, :3].T, precision=HIGHEST)
            # Slack: the merge recomputes world_dst = |m2w(om + t dm) - o|,
            # which carries the ADDITIVE round-trip error e = m2w(w2m(o))-o
            # (~ulps of |o| + translation, independent of W) on top of
            # relative ulps — so the safety margin needs an absolute floor
            # scaled by the origin magnitude, not only a relative factor
            slack0 = 8e-6 * (1.0 + jnp.sqrt(dot(o, o)))
            limit0 = (W_new[:, 0] * (1.0 + 4e-6) + slack0) \
                / jnp.sqrt(dot(wv, wv))
            M_new = M_new.at[:, 6].set(limit0)
            M = jnp.where(sb, M_new, M)
            if P > 1:
                M = M.at[:, 6].set(jnp.where(inert, NINF, M[:, 6]))
            SB, SM, SD = S
            cur0, SB, SM, SD, sp0, k0 = wide_enter(
                jnp.broadcast_to(root_rows[0], (BP, 128)),
                M_new[:, 0:3], M_new[:, 3:6], starts_pkt, SB, SM, SD,
                limit=jnp.where(starts, limit0, NINF) if P > 1 else limit0)
            S = (SB, SM, SD)
            I = I.at[:, I_CUR].set(jnp.where(starts_pkt, cur0, I[:, I_CUR]))
            I = I.at[:, I_SP].set(jnp.where(starts_pkt, sp0, I[:, I_SP]))
            I = I.at[:, I_SN].add(jnp.where(starts, rep(k0), 0))
        elif sph:
            # no triangle instances: the segment starts directly in the
            # sphere-BVH phase (world ray, best seeded from the brute
            # prepass — INF on pure-sphere scenes)
            M = jnp.where(sb, jnp.concatenate(
                [o, d, W_new[:, 0:1], jnp.zeros((B, 3))], axis=1), M)
            if P > 1:
                M = M.at[:, 6].set(jnp.where(inert, NINF, M[:, 6]))
            SB, SM, SD = S
            cur0, SB, SM, SD, sp0, k0 = wide_enter(
                jnp.broadcast_to(sph_root_row, (BP, 128)), o, d, starts_pkt,
                SB, SM, SD,
                limit=jnp.where(starts, W_new[:, 0], NINF) if P > 1
                else W_new[:, 0])
            S = (SB, SM, SD)
            I = I.at[:, I_CUR].set(jnp.where(starts_pkt, cur0, I[:, I_CUR]))
            I = I.at[:, I_SP].set(jnp.where(starts_pkt, sp0, I[:, I_SP]))
            I = I.at[:, I_SN].add(jnp.where(starts, rep(k0), 0))
        else:
            I = I.at[:, I_CUR].set(jnp.where(starts_pkt, -1, I[:, I_CUR]))
            I = I.at[:, I_SP].set(jnp.where(starts_pkt, 0, I[:, I_SP]))
        if ffwd:
            ptr0 = jnp.where(cur0 < 0, n_phase, 0)
        else:
            ptr0 = 0
        I = I.at[:, I_PTR].set(jnp.where(starts_pkt, ptr0, I[:, I_PTR]))
        I = I.at[:, I_TRI].set(jnp.where(
            starts | inert, SPH_SENT if (sph and n_bvh == 0) else -1,
            I[:, I_TRI]))
        I = I.at[:, I_STRI].set(jnp.where(starts, seg_tri2, I[:, I_STRI]))
        I = I.at[:, I_SMAT].set(jnp.where(starts, seg_mat2, I[:, I_SMAT]))
        I = I.at[:, I_FLAG].set(jnp.where(starts, seg_flag, I[:, I_FLAG]))
        return F, M, W, I, S

    return dict(n_bvh=n_bvh, n_phase=n_phase, sph=sph,
                traversal_step=traversal_step,
                advance_instance=advance_instance,
                resolve_and_shade=resolve_and_shade,
                start_segments=start_segments, stack_depth=D,
                nee_mode=nee_mode)


def _cumsum_i32(x):
    """Inclusive int32 cumsum of a (B,) vector via two triangular matmuls.
    Chosen before the H100 port, where it beat jnp.cumsum; queued for an
    H100 A/B (ROADMAP S7). Exact: counts < 2^24 in f32 HIGHEST. Falls back
    for non-128-multiples."""
    B = x.shape[0]
    if B % 128:
        return jnp.cumsum(x)
    n = B // 128
    g = x.astype(jnp.float32).reshape(n, 128)
    lt = jnp.tril(jnp.ones((128, 128), jnp.float32))
    within = jnp.dot(g, lt.T, precision=jax.lax.Precision.HIGHEST)
    ltn = jnp.tril(jnp.ones((n, n), jnp.float32), -1)
    prefix = jnp.dot(ltn, within[:, -1],
                     precision=jax.lax.Precision.HIGHEST)
    return (within + prefix[:, None]).reshape(B).astype(jnp.int32)


def _i0(B, seed, n_bvh, bounce0, BP=None):
    """Initial I-state. With ray packets, the traversal-control columns
    (I_CUR / I_PTR / I_SP) live at packet granularity ``BP``; everything
    else is per-ray (B,)."""
    BP = B if BP is None else BP
    return ColState([
        jax.lax.bitcast_convert_type(seed, jnp.int32),
        jnp.full((B,), bounce0, jnp.int32),
        jnp.zeros((B,), jnp.int32),
        jnp.full((BP,), -1, jnp.int32),   # I_CUR (packet)
        jnp.full((BP,), n_bvh, jnp.int32),  # I_PTR (packet)
        jnp.full((B,), -1, jnp.int32),
        jnp.zeros((B,), jnp.int32),
        jnp.full((B,), -1, jnp.int32),
        jnp.zeros((B,), jnp.int32),
        jnp.zeros((B,), jnp.int32),
        jnp.zeros((B,), jnp.int32),
        jnp.zeros((B,), jnp.int32),
        jnp.full((B,), -1, jnp.int32),   # pixel
        jnp.zeros((B,), jnp.int32),      # sample index
        jnp.zeros((BP,), jnp.int32),     # I_SP (packet)
        jnp.zeros((B,), jnp.int32),
    ])


def trace_batch_flat(scene: RenderScene, origin, direction, seed, *,
                     bounces: int, skybox: bool):
    """Drop-in replacement for trace_batch when the scene has BVH instances.
    Returns (incoming (B,4), seed, segments (B,))."""
    B = origin.shape[0]
    direction = normalize(direction)
    parts = _make_parts(scene, B, bounces, skybox)
    n_phase = parts["n_phase"]
    assert n_phase >= 1

    F0 = jnp.concatenate([origin, direction, jnp.ones((B, 4)),
                          jnp.zeros((B, 4))], axis=1)
    M0 = jnp.concatenate([jnp.zeros((B, 6)), jnp.full((B, 1), INF),
                          jnp.zeros((B, 3))], axis=1)
    W0 = jnp.concatenate([jnp.full((B, 1), INF), jnp.zeros((B, 11))], axis=1)
    I0 = _i0(B, seed, n_phase, -1)
    S0 = (jnp.zeros((B, parts["stack_depth"]), jnp.int32),) * 3

    def boundary(F, M, W, I, S):
        at_b = (I[:, I_PTR] >= n_phase) & (I[:, I_BOUNCE] != DONE)
        o, d, trans, incoming, seed, continues_path, _nee, _stash = \
            parts["resolve_and_shade"](F, W, I, at_b)
        started = I[:, I_BOUNCE] >= 0
        next_bounce = I[:, I_BOUNCE] + 1
        continues = at_b & (~started | continues_path) \
            & (next_bounce <= bounces)
        dies = at_b & ~continues
        F, M, W, I, S = parts["start_segments"](
            F, M, W, I, S, continues, o, d, trans, incoming, seed,
            jnp.where(continues, next_bounce, I[:, I_BOUNCE]))
        I = I.at[:, I_BOUNCE].set(jnp.where(dies, DONE, I[:, I_BOUNCE]))
        I = I.at[:, I_PTR].set(jnp.where(dies, n_phase, I[:, I_PTR]))
        I = I.at[:, I_CUR].set(jnp.where(dies, -1, I[:, I_CUR]))
        return F, M, W, I, S

    def cond(state):
        it, F, M, W, I, S = state
        return jnp.any(I[:, I_BOUNCE] != DONE)

    def body(state):
        it, F, M, W, I, S = state
        F, M, W, I, S = parts["traversal_step"](F, M, W, I, S)
        F, M, W, I, S = parts["traversal_step"](F, M, W, I, S)
        F, M, W, I, S = parts["advance_instance"](F, M, W, I, S)

        at_boundary = (I[:, I_PTR] >= n_phase) & (I[:, I_BOUNCE] != DONE)
        run_boundary = ((it % SHADE_EVERY) == 0) & jnp.any(at_boundary)
        F, M, W, I, S = jax.lax.cond(run_boundary, boundary,
                                     lambda *s: s, F, M, W, I, S)
        return it + 1, F, M, W, I, S

    _, F, M, W, I, _S = jax.lax.while_loop(cond, body,
                                           (jnp.int32(1), F0, M0, W0, I0, S0))
    incoming = F[:, 10:14]
    seed_out = jax.lax.bitcast_convert_type(I[:, I_SEED], jnp.uint32)
    return incoming, seed_out, I[:, I_SEGS]


def render_persistent(scene: RenderScene, frames, *, width: int, height: int,
                      bounces: int, rays_per_pixel: int, skybox: bool,
                      row_start=0, rows: int | None = None,
                      lanes: int | None = None, unroll: int | None = None,
                      shade_every: int = 0, cohorts: int = 1,
                      normal_maps: bool = False, claim: str = "queue",
                      boundaries: int = 1, log_cap: int | None = None,
                      claim_shuffle: bool = True,
                      antialias: bool = False, nee: bool = False,
                      packet: int | None = None,
                      return_iters: bool = False,
                      return_log_order: bool = False):
    """Persistent-lanes whole-image render. Returns ((rows, width, 4) image,
    total traced segments). Pixel p maps to (x = p %% width,
    y = row_start + p // width); RNG streams and sample continuation are
    identical to the tiled path (frag(), ray_tracer.wgsl:473-500).

    ``claim`` picks the pixel-assignment scheme — per-pixel values are
    IDENTICAL either way (seeds derive from the pixel id, not the lane):

    * "queue": shared cursor; finished lanes claim the next pixels in
      scan order (cumsum rank), completed pixels append to a compacted
      log (argsort) reassembled at the end.
    * "striped": lane L statically owns pixels L, L+B, L+2B ... —
      no cursor, no rank cumsum, no argsort compaction; completed pixels
      write into a (B, K) bank with a masked select and one final
      transpose. Cheaper boundary, but load balance relies on averaging
      path-length variance over the ~total/B pixels per lane.

    ``boundaries`` chains that many boundary phases per loop iteration
    (traversal scenes only — on no-traversal scenes every iteration IS a
    boundary already and the knob is a no-op).

    ``cohorts`` splits the lanes into that many independent sub-batches
    whose traversal steps are interleaved inside one loop body: cohort
    c+1's row gather has no data dependency on cohort c's, so XLA can
    issue it while cohort c's slab/leaf arithmetic runs — breaking the
    5-deep dependent-gather chain that stalls the single-batch schedule.
    Pixel values are
    unchanged (the work queue hands out the same pixel ids; seeds derive
    from pixel ids). Queue claim + ungated boundary only."""
    # defaults measured on the card (ray_tracer_2_tpu/tuning.py): explicit
    # kwarg > tuned.json for the active backend > built-in fallback (the
    # values last tuned before the H100 port; backends tuned.json does not
    # list, such as the CPU in tests, use them). Resolution is
    # per-process-stable, so the jit cache (keyed on the static values the
    # callers pass through) never sees a knob change under a live trace.
    # Scene-class tuning profile "bigtex": a big texel atlas can move the
    # lane-count optimum (tuned.json "<backend>:bigtex").
    assert not (return_log_order and claim == "striped"), \
        "return_log_order is a queue-claim probe hook (striped has no log)"
    assert not (return_log_order and return_iters), \
        "return_log_order and return_iters are mutually exclusive"
    profile = "bigtex" if scene.tex_texels.shape[0] >= 65536 else None
    lanes = tuning.resolve("lanes", lanes, 16384, profile=profile)
    unroll = tuning.resolve("unroll", unroll, 5, profile=profile)
    packet = tuning.resolve("packet", packet, 1, profile=profile)
    rows = height if rows is None else rows
    total = rows * width
    rpp = max(rays_per_pixel, 1)
    if cohorts > 1:
        assert claim == "queue" and shade_every == 0, \
            "cohorts>1 supports the default queue claim + ungated boundary"
        assert lanes % cohorts == 0
    if boundaries > 1:
        assert shade_every == 0 and claim == "queue", \
            "boundaries>1 requires the ungated queue boundary"
    B = lanes // cohorts
    # ---- ray packets (``packet`` = P rays per traversal lane): ``lanes``
    # keeps meaning RAYS in flight; row gathers and traversal control run
    # at B // P packet granularity (see _make_parts docstring). Claim
    # order stays scan-order (shuffle off): rays of a packet that restart
    # in the same boundary receive ADJACENT pixels, which is what keeps
    # primary packets coherent (scripts/sim_packet.py).
    packet = max(int(packet), 1)
    assert B % packet == 0, (B, packet)
    if packet > 1:
        assert claim == "queue" and shade_every == 0 and cohorts == 1, \
            "packet>1 supports the default queue claim + ungated boundary"
        claim_shuffle = False
    parts = _make_parts(scene, B, bounces, skybox, normal_maps, nee=nee,
                        packet=packet)
    BP = B // packet
    n_bvh = parts["n_bvh"]  # 0 is fine: boundary-only loop (no traversal)
    n_phase = parts["n_phase"]
    has_trav = n_phase > 0  # any BVH (triangle or sphere) to traverse

    def _rep(x):   # (BP,) -> (B,), identity at packet == 1
        if packet == 1:
            return x
        return jnp.broadcast_to(x[:, None], (BP, packet)).reshape(B)

    def _pkt_any(x):
        if packet == 1:
            return x
        return x.reshape(BP, packet).any(axis=1)

    cam = scene.cam_to_world
    cam_origin = cam[:3, 3]
    cam_right = cam[:3, 0]
    cam_up = cam[:3, 1]
    size = jnp.array([width, height], jnp.float32)
    inv_size_x = 1.0 / jnp.float32(width)

    def camera_ray(pixel, seed):
        """frag() camera-ray generation for lane pixels (2 disk draws)."""
        x = (pixel % width).astype(jnp.float32)
        y = (row_start + pixel // width).astype(jnp.float32)
        uv = jnp.stack([x, y], axis=1) / jnp.maximum(size - 1.0, 1.0)
        local_focus = jnp.stack([
            (uv[:, 0] - 0.5) * scene.view_params[0],
            (uv[:, 1] - 0.5) * scene.view_params[1],
            jnp.full((B,), scene.view_params[2]),
        ], axis=1)
        fp = jnp.dot(local_focus, cam[:3, :3].T, precision=HIGHEST) \
            + cam[:3, 3]
        if antialias:
            # box-filter sub-pixel jitter (RenderParams.antialias); draw
            # order matches trace.py sample_once exactly
            ju, seed = rng.rand(seed)
            jv, seed = rng.rand(seed)
            du = (ju - 0.5) * scene.view_params[0] / max(width - 1, 1)
            dv = (jv - 0.5) * scene.view_params[1] / max(height - 1, 1)
            fp = fp + cam_right * du[:, None] + cam_up * dv[:, None]
        dj, seed = rng.rand_in_unit_disk(seed)
        dj = dj * scene.defocus_strength * inv_size_x
        o = cam_origin + cam_right * dj[:, :1] + cam_up * dj[:, 1:]
        vj, seed = rng.rand_in_unit_disk(seed)
        vj = vj * scene.diverge_strength * inv_size_x
        fpj = fp + cam_right * vj[:, :1] + cam_up * vj[:, 1:]
        d = normalize(fpj - o)
        return o, d, seed

    F0 = jnp.concatenate([jnp.zeros((B, 6)), jnp.ones((B, 4)),
                          jnp.zeros((B, 4))], axis=1)
    if parts["nee_mode"] == 2:
        # shadow-stash columns 14:24 (continuation o/d, contribution, t_l)
        F0 = jnp.concatenate([F0, jnp.zeros((B, 10))], axis=1)
    M0 = jnp.concatenate([jnp.ones((B, 6)), jnp.full((B, 1), INF),
                          jnp.zeros((B, 3))], axis=1)
    W0 = jnp.concatenate([jnp.full((B, 1), INF), jnp.zeros((B, 11))], axis=1)
    I0 = _i0(B, jnp.zeros((B,), jnp.uint32), n_phase, IDLE, BP=BP)
    I0 = I0.at[:, I_SAMPLE].set(jnp.full((B,), rpp - 1, jnp.int32))  # first boundary claims a pixel
    A0 = jnp.zeros((B, 4))                # per-pixel sample accumulator
    S0 = (jnp.zeros((BP, parts["stack_depth"]), jnp.int32),) * 3
    # Completion LOG instead of a scatter target (chosen before the H100
    # port, whose scatter was slower than its gathers; queued for an H100
    # A/B, ROADMAP S6). Completed pixels are compacted to the front (stable
    # argsort of the done mask) and appended densely with
    # dynamic_update_slice; every pixel completes exactly once, so
    # log[:total] is a permutation of the frame and one sort at the end
    # reassembles it.
    striped = claim == "striped"
    # largest multiplier with overflow-free u32 products that is coprime
    # to total (bijectivity of idx*A mod total); 1 = identity (no shuffle)
    claim_mul = max(1, min(1021, (2**32 - 1) // max(total, 1)))
    while claim_mul > 1 and math.gcd(claim_mul, total) != 1:
        claim_mul -= 1
    if not claim_shuffle:
        claim_mul = 1
    if log_cap is None:
        # default cap: about half the lanes complete per boundary in the
        # worst case seen; 8192 halves the compaction take + log DUS width
        # with deferral engaging only on rare bursts (chosen before the
        # H100 port; queued for the H100 knob sweep, ROADMAP S3)
        log_cap = 8192
    log_cap = min(log_cap, B)
    K = -(-total // B)
    if striped:
        # per-lane pixel bank: lane L's k-th pixel (id k*B + L) lands in
        # bank[L, k]; final assembly is one transpose — no log machinery
        logv0 = jnp.zeros((B, K, 4), jnp.float32)
        logp0 = jnp.zeros((1,), jnp.int32)
    else:
        # one (5, total+B) payload buffer: rgba in rows 0:4, the PIXEL ID
        # bitcast into row 4 — carrying the id inside the payload makes
        # compaction one take + one DUS instead of a separate id gather.
        # The buffer is TRANSPOSED (pixels on the MINOR axis) so the
        # per-iteration append is contiguous.
        logv0 = jnp.zeros((5, total + B), jnp.float32)
        logp0 = jnp.zeros((1,), jnp.int32)
    lane_ids = jnp.arange(B, dtype=jnp.int32)
    k_cols = jnp.arange(K, dtype=jnp.int32)[None, :, None]

    def boundary(F, M, W, I, S, A, logv, logp, cursor, wcursor):
        at_b = _rep(I[:, I_PTR] >= n_phase) & (I[:, I_BOUNCE] != DONE)
        o, d, trans, incoming, seed, continues_path, nee_new, nee_stash = \
            parts["resolve_and_shade"](F, W, I, at_b)
        bounce = I[:, I_BOUNCE]
        idle = bounce == IDLE
        next_bounce = bounce + 1
        continues = at_b & ~idle & continues_path & (next_bounce <= bounces)
        sample_end = at_b & ~continues

        # ---- sample end: bank the sample, maybe start the next one ----
        sample_i = I[:, I_SAMPLE]
        more_samples = sample_end & ~idle & (sample_i + 1 < rpp)
        pixel_done = sample_end & ~more_samples  # includes idle lanes
        nee_commit = at_b  # lanes whose resolve takes effect this round
        valid_px = pixel_done & (I[:, I_PIXEL] >= 0)

        if log_cap < B and not striped:
            # LOG-WIDTH CAP: at most ``log_cap`` pixels append to the
            # completion log per boundary, so the compaction take and the
            # log dynamic-update-slice are (5, log_cap) instead of (5, B)
            # — the per-row gather/DUS charge is the boundary's biggest
            # fixed cost. Completions past the cap are DEFERRED: the lane
            # is treated as not-at-boundary this round (every derived mask
            # excludes it) and its resolve-mutated registers (o/d/trans/
            # incoming/seed) are reverted to the carried state, so the
            # next boundary's re-resolve replays bit-identically.
            vcnt = _cumsum_i32(valid_px.astype(jnp.int32))
            defer = valid_px & (vcnt > log_cap)
            sample_end = sample_end & ~defer
            pixel_done = pixel_done & ~defer
            valid_px = valid_px & ~defer
            dc = defer[:, None]
            o = jnp.where(dc, F[:, 0:3], o)
            d = jnp.where(dc, F[:, 3:6], d)
            trans = jnp.where(dc, F[:, 6:10], trans)
            incoming = jnp.where(dc, F[:, 10:14], incoming)
            seed = jnp.where(
                defer, jax.lax.bitcast_convert_type(I[:, I_SEED],
                                                    jnp.uint32), seed)
            continues = continues & ~defer
            nee_commit = nee_commit & ~defer  # replayed resolve recomputes
        A = jnp.where((sample_end & ~idle)[:, None], A + incoming, A)
        if striped:
            # pixel complete → masked select into the lane's bank column
            k_cur = jnp.maximum(I[:, I_PIXEL], 0) // B
            write = valid_px[:, None, None] & (k_cols == k_cur[:, None, None])
            logv = jnp.where(write, (A / jnp.float32(rpp))[:, None, :], logv)
            # claim: the lane's next owned pixel — no cursor, no rank
            claiming = pixel_done
            new_pixel = jnp.where(I[:, I_PIXEL] < 0, lane_ids,
                                  I[:, I_PIXEL] + B)
            got_job = claiming & (new_pixel < total)
        else:
            # pixel complete → append to the completion log (owned pixels
            # only). Compaction = stable argsort of the done mask +
            # gathers.
            perm = jnp.argsort(jnp.logical_not(valid_px), stable=True)
            payload = jnp.concatenate(
                [(A / jnp.float32(rpp)).T,
                 encode_log_ids(I[:, I_PIXEL])[None, :]], axis=0)
            pay_c = jnp.take(payload, perm[:log_cap], axis=1)
            logv = jax.lax.dynamic_update_slice(logv, pay_c, (0, wcursor))
            wcursor = jnp.minimum(
                wcursor + jnp.sum(valid_px.astype(jnp.int32)), total)

            # claim new pixels from the cursor (rank = exclusive cumsum)
            claiming = pixel_done
            rank = _cumsum_i32(claiming.astype(jnp.int32)) \
                - claiming.astype(jnp.int32)
            new_idx = cursor + rank
            got_job = claiming & (new_idx < total)
            # CLAIM-ORDER SHUFFLE: scan-order claims hand out the heavy
            # geometry's pixels in solid clusters (whole iterations with
            # every lane traversing and zero retires, then sky stretches
            # with idle traversal slots). Mapping the claim index through
            # a fixed multiplicative bijection idx -> idx*A mod total
            # spreads them uniformly, keeping retire rate AND traversal
            # occupancy near their averages. Pure vector arithmetic (no
            # gather); bit-exact — pixel values derive from pixel ids and
            # the log reassembles by id. A <= 1023 keeps idx*A < 2^31.
            new_pixel = (new_idx.astype(jnp.uint32) * jnp.uint32(claim_mul)
                         % jnp.uint32(total)).astype(jnp.int32)
            new_pixel = jnp.where(got_job, new_pixel, new_idx)
            cursor = cursor + jnp.sum(claiming.astype(jnp.int32))
            cursor = jnp.minimum(cursor, total)

        pixel = jnp.where(got_job, new_pixel, I[:, I_PIXEL])
        fresh_seed = rng.seed_for_pixel(
            ((row_start + pixel // width) * width + pixel % width
             ).astype(jnp.uint32), frames)
        seed = jnp.where(got_job, fresh_seed, seed)
        sample_i = jnp.where(got_job, 0,
                             jnp.where(more_samples, sample_i + 1, sample_i))
        A = jnp.where(got_job[:, None], 0.0, A)

        # new camera rays for restarted lanes (same draws as frag())
        restart = got_job | more_samples
        o_c, d_c, seed_c = camera_ray(pixel, seed)
        o = jnp.where(restart[:, None], o_c, o)
        d = jnp.where(restart[:, None], d_c, d)
        seed = jnp.where(restart, seed_c, seed)
        trans = jnp.where(restart[:, None], 1.0, trans)
        incoming = jnp.where((restart | sample_end)[:, None], 0.0, incoming)

        starts = continues | restart
        new_bounce = jnp.where(restart, 0,
                               jnp.where(continues, next_bounce, bounce))
        if nee_new is not None:
            # a lane STARTING a shadow segment (bit1 of its new state)
            # keeps its bounce across the shadow leg; the continuation
            # advances it at the shadow-resume boundary instead
            shadow_started = nee_commit & ((nee_new & 2) != 0)
            new_bounce = jnp.where(shadow_started, bounce, new_bounce)
        F, M, W, I, S = parts["start_segments"](F, M, W, I, S, starts, o, d,
                                                trans, incoming, seed,
                                                new_bounce)
        I = I.at[:, I_PIXEL].set(pixel)
        I = I.at[:, I_SAMPLE].set(sample_i)
        if nee_new is not None:
            # restarted lanes begin a fresh path: primary-hit emission must
            # show, so the suppression bit clears with the restart
            I = I.at[:, I_NEE].set(jnp.where(
                restart, 0, jnp.where(nee_commit, nee_new, I[:, I_NEE])))
        if nee_stash is not None:
            # stash the continuation ray + pending contribution for lanes
            # that just started a shadow segment (deferred lanes revert)
            tail = jnp.where(nee_commit[:, None], nee_stash, F[:, 14:24])
            F = jnp.concatenate([F[:, :14], tail], axis=1)
        retire = pixel_done & ~got_job
        I = I.at[:, I_BOUNCE].set(jnp.where(retire, DONE, I[:, I_BOUNCE]))
        # Packets where NO ray started a segment stay parked at the
        # boundary (ptr == n_phase, cur == -1): all-retired packets stop
        # traversing, and all-deferred packets replay their resolve next
        # iteration. (A completed segment already satisfies both values;
        # the set is defensive, matching the scalar kernel.)
        stall = _pkt_any(at_b) & ~_pkt_any(starts)
        I = I.at[:, I_PTR].set(jnp.where(stall, n_phase, I[:, I_PTR]))
        I = I.at[:, I_CUR].set(jnp.where(stall, -1, I[:, I_CUR]))
        return F, M, W, I, S, A, logv, logp, cursor, wcursor

    def cond(state):
        it, cohs, logv, logp, cursor, wcursor = state
        live = [jnp.any(c[3][:, I_BOUNCE] != DONE) for c in cohs]
        out = live[0]
        for l in live[1:]:
            out = out | l
        return out

    def body(state):
        it, cohs, logv, logp, cursor, wcursor = state
        cohs = list(cohs)
        if has_trav:
            # fixed unrolled window (an adaptive while_loop window cannot
            # be unrolled and pays per-step loop overhead). Cohorts
            # interleave per STEP (A1 B1 A2 B2 ...) so each cohort's next
            # gather overlaps the others' arithmetic.
            for _ in range(unroll):
                for c in range(cohorts):
                    F, M, W, I, S, A = cohs[c]
                    F, M, W, I, S = parts["traversal_step"](
                        F, M, W, I, S)
                    cohs[c] = (F, M, W, I, S, A)
            for c in range(cohorts):
                F, M, W, I, S, A = cohs[c]
                F, M, W, I, S = parts["advance_instance"](F, M, W, I, S)
                cohs[c] = (F, M, W, I, S, A)
            if shade_every == 0:
                # UNGATED: the boundary runs inline every iteration. The
                # lax.cond is a scheduling barrier — inlining lets XLA
                # overlap the boundary's dependent gathers (attr fetch)
                # with the traversal window's gather slots. All boundary
                # updates are masked, so a no-lane boundary is a no-op
                # (the log append writes garbage PAST wcursor, which later
                # valid appends overwrite before wcursor reaches it).
                # Cohort boundaries serialize only on the shared
                # cursor/log tail — the heavy resolve/shade gathers stay
                # independent across cohorts.
                #
                # ``boundaries`` > 1 chains EXTRA boundary phases back to
                # back: the dead-traversal fast-forward in start_segments
                # leaves a freshly claimed lane whose segment never enters
                # the tree (sky, or a prepass sphere/brute hit) already at
                # I_PTR == n_phase, so the NEXT boundary in the chain can
                # resolve it and claim again. On scenes where most segments
                # skip traversal (dragon: ~87%) this multiplies pixel
                # throughput per iteration without adding traversal windows.
                for _ in range(boundaries):
                    for c in range(cohorts):
                        F, M, W, I, S, A = cohs[c]
                        F, M, W, I, S, A, logv, logp, cursor, wcursor = \
                            boundary(F, M, W, I, S, A, logv, logp, cursor,
                                     wcursor)
                        cohs[c] = (F, M, W, I, S, A)
            else:
                F, M, W, I, S, A = cohs[0]
                at_boundary = (I[:, I_PTR] >= n_phase) \
                    & (I[:, I_BOUNCE] != DONE)
                run_boundary = ((it % shade_every) == 0) \
                    & jnp.any(at_boundary)
                F, M, W, I, S, A, logv, logp, cursor, wcursor = jax.lax.cond(
                    run_boundary, boundary, lambda *s: s,
                    F, M, W, I, S, A, logv, logp, cursor, wcursor)
                cohs[0] = (F, M, W, I, S, A)
        else:
            # no BVH instances: every iteration is a boundary (prepass is
            # the whole intersection work)
            for c in range(cohorts):
                F, M, W, I, S, A = cohs[c]
                F, M, W, I, S, A, logv, logp, cursor, wcursor = boundary(
                    F, M, W, I, S, A, logv, logp, cursor, wcursor)
                cohs[c] = (F, M, W, I, S, A)
        return it + 1, tuple(cohs), logv, logp, cursor, wcursor

    coh0 = tuple((F0, M0, W0, I0, S0, A0) for _ in range(cohorts))
    state = (jnp.int32(0), coh0, logv0, logp0,
             jnp.int32(0), jnp.int32(0))
    n_it, cohs, logv, logp, cursor, wcursor = \
        jax.lax.while_loop(cond, body, state)
    segments = sum(jnp.sum(c[3][:, I_SEGS].astype(jnp.float32))
                   for c in cohs)
    if striped:
        # bank[L, k] holds pixel k*B + L: one transpose reassembles
        out = logv.transpose(1, 0, 2).reshape(K * B, 4)[:total]
    else:
        # reassemble: log pixel ids (payload row 4) are a permutation of
        # [0, total)
        pix = decode_log_ids(logv[4, :total])
        # ONE multi-operand sort carries the rgba payload with the pixel
        # keys (no separate argsort + take); keys are a permutation, so
        # stability is irrelevant
        _, r_s, g_s, b_s, a_s = jax.lax.sort(
            (pix, logv[0, :total], logv[1, :total], logv[2, :total],
             logv[3, :total]), num_keys=1)
        out = jnp.stack([r_s, g_s, b_s, a_s], axis=1)
        if return_log_order:
            # probe hook (scripts/onchip_r4c.py): the pre-sort pixel-id
            # sequence, i.e. pixel COMPLETION order — measures how far the
            # log drifts from claim order, which bounds any banded/windowed
            # replacement of the end-of-frame reassembly sort. The kernel's
            # ACTUAL claim multiplier rides along so callers never re-derive
            # it (claim_shuffle can be forced off, e.g. by packet > 1).
            return (out.reshape(rows, width, 4), segments, pix,
                    jnp.int32(claim_mul))
    if return_iters:
        return out.reshape(rows, width, 4), segments, n_it
    return out.reshape(rows, width, 4), segments

"""Whole-path Pallas kernel for SMALL scenes (spheres + small meshes).

metal / balls / random_balls have no BVH instances and no textures;
cornell_box (32 tris) and room (12 tris + glass spheres) add only small
meshes. For all of them the entire path trace — camera rays, dense sphere
AND triangle intersection, glass/diffuse/specular shading, russian
roulette, rays_per_pixel accumulation — runs in ONE kernel launch with no
device-memory traffic in the loop besides the (cached) scene tables. This
is the reference's own design: one thread traces one pixel's whole path
(ray_tracer.wgsl:473-500).

Written for the GPU through Pallas' Triton route (``backend="triton"``):

  * one program per block of ``BLOCK`` rays (one pixel each), state held
    as (BLOCK,) vectors in registers;
  * the rays_per_pixel loop runs outside the bounce loop, and the bounce
    loop is a ``while`` that exits as soon as every path of the block has
    terminated (sky strips die after one or two bounces);
  * primitives are intersected ``CHUNK`` at a time as a (BLOCK, CHUNK)
    tile with a min-reduce — the lowest id wins distance ties, as in the
    XLA path's argmin;
  * winner fields come from one indexed load per field out of a
    (primitive, field) table, row ``C`` of which is all zero (misses);
  * mesh triangles are pre-baked to WORLD space (instance transforms
    applied once at table build, winding swapped under reflecting
    transforms), so the kernel needs no per-ray instance math.

Physics and RNG stream are those of kernels/trace.py trace_batch
(ray_tracer.wgsl:398-471), draw for draw. Results match the XLA path to
FP noise: the hit distances here are world distances, where the XLA brute
path measures model-space rays and re-measures (tests/test_pallas_spheres.py
runs the kernel in interpret mode on CPU).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from ray_tracer_2_tpu import rng
from ray_tracer_2_tpu.scene.render_scene import RenderScene

INF = float(np.float32(1.7014118e38))
GLASS = 1
BLOCK = 128        # rays per program
CHUNK = 16         # primitives per (BLOCK, CHUNK) intersection tile
NUM_WARPS = 4

# field-table columns (see _pack_tables): 0:32 = the mat_rows layout, then
# the winner sphere's centre, then the winner triangle's three WORLD-space
# vertex normals (for barycentric shading)
F_PX = 32
F_N0 = 35          # n0 (3 cols), n1 (3), n2 (3)
N_FIELDS = 44

#: small-MESH scenes also run whole-path: triangles baked to world space
#: stream through the same tile loop as spheres. The cap was chosen before
#: the H100 port and is queued for an H100 measurement.
MAX_TRIS = 64


def _tri_count(scene: RenderScene) -> int:
    return sum(c for _, _, c in scene.inst_spans)


def eligible(scene: RenderScene) -> bool:
    """Whole-path kernel: scenes whose geometry is spheres plus SMALL
    meshes (total tris <= MAX_TRIS, e.g. Cornell Box's 32), with no
    texture sampling."""
    T = _tri_count(scene)
    if T > MAX_TRIS:
        return False
    if T == 0 and scene.n_spheres == 0:
        return False
    flags = np.asarray(scene.materials.flag)
    diff = np.asarray(scene.materials.diffuse_index)
    return bool((flags != 2).all() and (diff < 0).all())


def _padded(n: int) -> int:
    """Table rows: a whole number of CHUNKs, at least one."""
    return max(-(-n // CHUNK), 1) * CHUNK


def _norm3(x, y, z):
    inv = jax.lax.rsqrt(x * x + y * y + z * z)
    return x * inv, y * inv, z * inv


def _rand_direction(seed):
    """rng.rand_direction, component-wise (draw order x, y, z preserved)."""
    x, seed = rng.rand_normal(seed)
    y, seed = rng.rand_normal(seed)
    z, seed = rng.rand_normal(seed)
    x, y, z = _norm3(x, y, z)
    return x, y, z, seed


def _disk(seed):
    """rng.rand_in_unit_disk, component-wise."""
    u1, seed = rng.rand(seed)
    angle = u1 * 2.0 * 3.1415926
    u2, seed = rng.rand(seed)
    rr = jnp.sqrt(u2)
    return jnp.cos(angle) * rr, jnp.sin(angle) * rr, seed


def _make_kernel(S: int, S_pad: int, T: int, T_pad: int, bounces: int,
                 rpp: int, skybox: bool, width: int, total: int,
                 row_start: int):
    from ray_tracer_2_tpu.kernels import trace as _t
    from ray_tracer_2_tpu.kernels.intersect import sphere_fast_min
    from ray_tracer_2_tpu.kernels.trace import _reflectance

    HORIZON = [float(v) for v in np.asarray(_t.SKY_HORIZON)]
    ZENITH = [float(v) for v in np.asarray(_t.SKY_ZENITH)]
    GROUND = [float(v) for v in np.asarray(_t.GROUND_COLOR)]
    SUN_FOCUS = float(_t.SUN_FOCUS)
    SUN_INTENSITY = float(_t.SUN_INTENSITY)
    fast = S >= sphere_fast_min()
    C = S_pad + T_pad   # combined id space; id C = miss (all-zero row)
    span = bounces + 1
    SHAPE = (BLOCK,)

    def smoothstep(e0, e1, x):
        t = jnp.clip((x - e0) / (e1 - e0), 0.0, 1.0)
        return t * t * (3.0 - 2.0 * t)

    def env_light(dx, dy, dz):
        sky_t = smoothstep(0.0, 0.4, dy) ** 0.35
        g2s = smoothstep(-0.01, 0.0, dy)
        sun = jnp.maximum(0.0, dx * 0.1 + dy * 1.0 + dz * 0.1) \
            ** SUN_FOCUS * SUN_INTENSITY
        sun = jnp.where(g2s >= 1.0, sun, 0.0)
        out = []
        for c in range(4):
            sky = HORIZON[c] + (ZENITH[c] - HORIZON[c]) * sky_t
            comp = GROUND[c] + (sky - GROUND[c]) * g2s
            out.append(comp + sun)
        return out

    def kernel(frames_ref, cam_ref, sph_ref, tri_ref, fld_ref,
               or_ref, og_ref, ob_ref, oa_ref, seg_ref):
        frames = frames_ref[0]
        (r00, r01, r02, r10, r11, r12, r20, r21, r22,
         cx, cy, cz, vp0, vp1, vp2, defocus, diverge, im_h) = [
            cam_ref[i] for i in range(18)]

        chunk_ids = jax.lax.broadcasted_iota(jnp.int32, (1, CHUNK), 1)
        pixel = pl.program_id(0) * BLOCK \
            + jax.lax.broadcasted_iota(jnp.int32, SHAPE, 0)
        in_image = jnp.where(pixel < total, 1.0, 0.0)
        row = row_start + pixel // width
        col = pixel % width
        seed0 = (row * width + col).astype(jnp.uint32) \
            + jnp.abs(frames).astype(jnp.uint32) * jnp.uint32(719393)

        u = col.astype(jnp.float32) / jnp.maximum(
            jnp.float32(width) - 1.0, 1.0)
        v = row.astype(jnp.float32) / jnp.maximum(im_h - 1.0, 1.0)
        lfx = (u - 0.5) * vp0
        lfy = (v - 0.5) * vp1
        fx = r00 * lfx + r01 * lfy + r02 * vp2 + cx
        fy = r10 * lfx + r11 * lfy + r12 * vp2 + cy
        fz = r20 * lfx + r21 * lfy + r22 * vp2 + cz

        def cols(ref, k, n):
            return [ref[pl.ds(k * CHUNK, CHUNK), c][None, :]
                    for c in range(n)]

        def sphere_pass(ox, oy, oz, dx, dy, dz):
            """Closest hit over all spheres, CHUNK at a time. Returns
            (best_dst, winner id, inside) as (BLOCK,) vectors."""
            rox, roy, roz = ox[:, None], oy[:, None], oz[:, None]
            rdx, rdy, rdz = dx[:, None], dy[:, None], dz[:, None]
            a = rdx * rdx + rdy * rdy + rdz * rdz
            if fast:
                # shared-term hoists, SAME formula + op order as
                # intersect.ray_sphere_fast
                inv_a = 1.0 / a
                oo = rox * rox + roy * roy + roz * roz
                od = rox * rdx + roy * rdy + roz * rdz

            def chunk(k, carry):
                bd, bi, bin_ = carry
                px, py, pz, rad, kq = cols(sph_ref, k, 5)
                if fast:
                    cd = px * rdx + py * rdy + pz * rdz
                    co = px * rox + py * roy + pz * roz
                    h = od - cd
                    cq = oo - 2.0 * co + kq
                    disc = h * h - a * cq
                    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
                    dn = jnp.maximum(0.0, (-h - sq) * inv_a)
                    df = (-h + sq) * inv_a
                else:
                    ocx, ocy, ocz = rox - px, roy - py, roz - pz
                    b = 2.0 * (ocx * rdx + ocy * rdy + ocz * rdz)
                    cq = ocx * ocx + ocy * ocy + ocz * ocz - rad * rad
                    disc = b * b - 4.0 * a * cq
                    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
                    dn = jnp.maximum(0.0, (-b - sq) / (2.0 * a))
                    df = (-b + sq) / (2.0 * a)
                inside = dn == 0.0
                hit_s = (disc >= 0.0) & (df >= 0.001)
                dstw = jnp.where(hit_s, jnp.where(inside, df, dn), INF)
                m = jnp.min(dstw, axis=1)
                gid = chunk_ids + k * CHUNK
                cand = dstw == m[:, None]
                idw = jnp.min(jnp.where(cand, gid, S_pad), axis=1)
                winc = cand & (gid == idw[:, None])
                ins = jnp.max(jnp.where(winc & inside, 1.0, 0.0), axis=1)
                better = m < bd
                return (jnp.where(better, m, bd),
                        jnp.where(better, idw, bi),
                        jnp.where(better, ins, bin_))

            return jax.lax.fori_loop(
                0, S_pad // CHUNK, chunk,
                (jnp.full(SHAPE, INF, jnp.float32),
                 jnp.full(SHAPE, S_pad, jnp.int32),
                 jnp.zeros(SHAPE, jnp.float32)))

        def tri_pass(ox, oy, oz, dx, dy, dz):
            """Closest hit over all WORLD-baked triangles, Möller–Trumbore
            per kernels/intersect.py:ray_triangle (geometric normal
            precomputed at bake time). Returns (best_dst, winner id, u, v,
            det) as (BLOCK,) vectors."""
            rox, roy, roz = ox[:, None], oy[:, None], oz[:, None]
            rdx, rdy, rdz = dx[:, None], dy[:, None], dz[:, None]

            def chunk(k, carry):
                bd, bi, bu, bv, bdet = carry
                (v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z,
                 gnx, gny, gnz, cullc) = cols(tri_ref, k, 13)
                det = -(rdx * gnx + rdy * gny + rdz * gnz)
                cull_b = cullc > 0.5
                keep = (cull_b & (det >= 1e-8)) \
                    | (~cull_b & (jnp.abs(det) >= 1e-8))
                inv = 1.0 / jnp.where(keep, det, 1.0)
                aox, aoy, aoz = rox - v0x, roy - v0y, roz - v0z
                daox = aoy * rdz - aoz * rdy
                daoy = aoz * rdx - aox * rdz
                daoz = aox * rdy - aoy * rdx
                dst = (aox * gnx + aoy * gny + aoz * gnz) * inv
                u = (e2x * daox + e2y * daoy + e2z * daoz) * inv
                v = -(e1x * daox + e1y * daoy + e1z * daoz) * inv
                w = 1.0 - u - v
                hitt = keep & (dst > 1e-5) & (u >= 0.0) & (v >= 0.0) \
                    & (w >= 0.0)
                dstw = jnp.where(hitt, dst, INF)
                m = jnp.min(dstw, axis=1)
                gid = chunk_ids + k * CHUNK
                cand = dstw == m[:, None]
                idw = jnp.min(jnp.where(cand, gid, T_pad), axis=1)
                winc = cand & (gid == idw[:, None])

                def pick(x):
                    return jnp.sum(jnp.where(winc, x, 0.0), axis=1)

                better = m < bd
                return (jnp.where(better, m, bd),
                        jnp.where(better, idw, bi),
                        jnp.where(better, pick(u), bu),
                        jnp.where(better, pick(v), bv),
                        jnp.where(better, pick(det), bdet))

            zero = jnp.zeros(SHAPE, jnp.float32)
            return jax.lax.fori_loop(
                0, T_pad // CHUNK, chunk,
                (jnp.full(SHAPE, INF, jnp.float32),
                 jnp.full(SHAPE, T_pad, jnp.int32), zero, zero, zero))

        def bounce(b, state):
            """One segment of every live path (ray_tracer.wgsl:398-471)."""
            (ox, oy, oz, dx, dy, dz, tr, inc, alive, segs, seed) = state
            alive_b = alive > 0.0
            segs = segs + alive

            # spheres first, then world-baked triangles; distance ties go
            # to the sphere (matches the XLA prepass's strict < merge)
            if S:
                sd, swin, sins = sphere_pass(ox, oy, oz, dx, dy, dz)
            else:
                sd = jnp.full(SHAPE, INF, jnp.float32)
                swin = jnp.full(SHAPE, C, jnp.int32)
                sins = jnp.zeros(SHAPE, jnp.float32)
            if T:
                td, tid, tu, tv, tdet = tri_pass(ox, oy, oz, dx, dy, dz)
                tri_win = td < sd
                sd = jnp.minimum(sd, td)
                winner = jnp.where(tri_win, S_pad + tid, swin)
                backface = (tri_win & (tdet < 0.0)) \
                    | (~tri_win & (sins > 0.0))
            else:
                winner = swin
                backface = sins > 0.0
            hit = alive_b & (sd < INF)
            wid = jnp.where(hit, winner, C)

            def field(c):
                return fld_ref[wid, c]

            m_color = [field(c) for c in range(0, 4)]
            m_emis = [field(c) for c in range(4, 8)]
            m_spec_c = [field(c) for c in range(8, 12)]
            m_abs = [field(c) for c in range(12, 15)]
            m_abs_k, m_emis_k = field(16), field(17)
            m_smooth, m_spec = field(18), field(19)
            m_ior = jnp.where(hit, field(20), 1.0)  # no 1/0 on miss lanes
            is_glass = field(21) == float(GLASS)

            hx, hy, hz = ox + dx * sd, oy + dy * sd, oz + dz * sd
            if S:
                nx, ny, nz = _norm3(hx - field(F_PX), hy - field(F_PX + 1),
                                    hz - field(F_PX + 2))
                flip = jnp.where(backface, -1.0, 1.0)
                nx, ny, nz = nx * flip, ny * flip, nz * flip
            else:
                nx = ny = nz = jnp.zeros(SHAPE, jnp.float32)
            if T:
                # barycentric world-normal interpolation; sign(det) points
                # the normal back toward the ray (trace.py semantics)
                wbar = 1.0 - tu - tv
                sgn = jnp.where(tdet < 0.0, -1.0, 1.0)
                tn = [(field(F_N0 + c) * wbar + field(F_N0 + 3 + c) * tu
                       + field(F_N0 + 6 + c) * tv) * sgn for c in range(3)]
                tnx, tny, tnz = _norm3(*tn)
                nx = jnp.where(tri_win, tnx, nx)
                ny = jnp.where(tri_win, tny, ny)
                nz = jnp.where(tri_win, tnz, nz)

            # ---- miss: environment light -------------------------------
            if skybox:
                missed = alive_b & ~hit
                env = env_light(dx, dy, dz)
                inc = [jnp.where(missed, inc[c] + tr[c] * env[c], inc[c])
                       for c in range(4)]

            # reflect dir shared by both branches
            ddn = dx * nx + dy * ny + dz * nz
            rfx, rfy, rfz = dx - 2.0 * ddn * nx, dy - 2.0 * ddn * ny, \
                dz - 2.0 * ddn * nz

            # ---- glass branch (ray_tracer.wgsl:414-436) ----------------
            gb = is_glass & backface
            tr_g = [jnp.where(gb, tr[c] * jnp.exp(-sd * m_abs[c] * m_abs_k),
                              tr[c]) for c in range(3)] \
                + [jnp.where(gb, 1.0, tr[3])]
            ior = jnp.where(backface, m_ior, 1.0 / m_ior)
            cos_i = nx * dx + ny * dy + nz * dz
            kk = 1.0 - ior * ior * (1.0 - cos_i * cos_i)
            okk = kk >= 0.0
            kr = jnp.sqrt(jnp.maximum(kk, 0.0))
            rrx = jnp.where(okk, ior * dx - (ior * cos_i + kr) * nx, 0.0)
            rry = jnp.where(okk, ior * dy - (ior * cos_i + kr) * ny, 0.0)
            rrz = jnp.where(okk, ior * dz - (ior * cos_i + kr) * nz, 0.0)
            cos_t = jnp.minimum(-(dx * nx + dy * ny + dz * nz), 1.0)
            sin_t = jnp.sqrt(jnp.maximum(1.0 - cos_t * cos_t, 0.0))
            cannot = ior * sin_t > 1.0
            r_refl, seed_refl = rng.rand(seed)
            seed_g = jnp.where(cannot, seed, seed_refl)
            follow = cannot | (_reflectance(cos_t, ior) > r_refl)
            gxx, gyy, gzz, seed_g = _rand_direction(seed_g)
            dfx, dfy, dfz = _norm3(nx + gxx, ny + gyy, nz + gzz)
            remx, remy, remz = _norm3(dfx + (rfx - dfx) * m_spec,
                                      dfy + (rfy - dfy) * m_spec,
                                      dfz + (rfz - dfz) * m_spec)
            rmx, rmy, rmz = _norm3(-dfx + (rrx + dfx) * m_smooth,
                                   -dfy + (rry + dfy) * m_smooth,
                                   -dfz + (rrz + dfz) * m_smooth)
            gdx = jnp.where(follow, remx, rmx)
            gdy = jnp.where(follow, remy, rmy)
            gdz = jnp.where(follow, remz, rmz)
            gsgn = jnp.sign(nx * gdx + ny * gdy + nz * gdz)
            gox = hx + 1e-4 * nx * gsgn
            goy = hy + 1e-4 * ny * gsgn
            goz = hz + 1e-4 * nz * gsgn

            # ---- diffuse/specular branch (wgsl:437-459) ----------------
            r_spec, seed_n = rng.rand(seed)
            is_spec = m_spec >= r_spec
            ux, uy, uz, seed_n = _rand_direction(seed_n)
            hemi = jnp.sign(nx * ux + ny * uy + nz * uz)
            hemi = jnp.where(hemi == 0.0, 1.0, hemi)
            hdx, hdy, hdz = ux * hemi, uy * hemi, uz * hemi
            mix_t = jnp.where(is_spec, m_smooth, 0.0)
            ndx, ndy, ndz = _norm3(hdx + (rfx - hdx) * mix_t,
                                   hdy + (rfy - hdy) * mix_t,
                                   hdz + (rfz - hdz) * mix_t)
            inc_n = [inc[c] + m_emis[c] * m_emis_k * tr[c] for c in range(4)]
            tr_n = [tr[c] * jnp.where(is_spec, m_spec_c[c], m_color[c])
                    for c in range(4)]

            # ---- select branch + russian roulette ----------------------
            ndx = jnp.where(is_glass, gdx, ndx)
            ndy = jnp.where(is_glass, gdy, ndy)
            ndz = jnp.where(is_glass, gdz, ndz)
            nox = jnp.where(is_glass, gox, hx)
            noy = jnp.where(is_glass, goy, hy)
            noz = jnp.where(is_glass, goz, hz)
            ntr = [jnp.where(is_glass, tr_g[c], tr_n[c]) for c in range(4)]
            inc = [jnp.where(is_glass | ~hit, inc[c], inc_n[c])
                   for c in range(4)]
            nseed = jnp.where(is_glass, seed_g, seed_n)

            p = jnp.maximum(ntr[0], jnp.maximum(ntr[1], ntr[2]))
            r_rr, nseed = rng.rand(nseed)
            survive = r_rr < p
            pd = jnp.where(p > 0.0, p, 1.0)

            return (jnp.where(hit, nox, ox), jnp.where(hit, noy, oy),
                    jnp.where(hit, noz, oz), jnp.where(hit, ndx, dx),
                    jnp.where(hit, ndy, dy), jnp.where(hit, ndz, dz),
                    [jnp.where(hit, ntr[c] / pd, tr[c]) for c in range(4)],
                    inc, jnp.where(hit & survive, 1.0, 0.0), segs,
                    jnp.where(hit, nseed, seed))

        def sample(s, carry):
            """One camera sample per pixel (frag(), wgsl:487-497); dead
            lanes never advance their seed, so the block's early exit
            from the bounce loop is exact."""
            acc, segs, seed = carry
            d0x, d0y, seed = _disk(seed)
            jx, jy = d0x * defocus, d0y * defocus
            ox = cx + r00 * jx + r01 * jy      # camera right/up = columns
            oy = cy + r10 * jx + r11 * jy
            oz = cz + r20 * jx + r21 * jy
            v0x, v0y, seed = _disk(seed)
            vx, vy = v0x * diverge, v0y * diverge
            dx, dy, dz = _norm3(fx + r00 * vx + r01 * vy - ox,
                                fy + r10 * vx + r11 * vy - oy,
                                fz + r20 * vx + r21 * vy - oz)
            one = jnp.ones(SHAPE, jnp.float32)
            zero = jnp.zeros(SHAPE, jnp.float32)

            def live(c):
                b, state = c
                return (b < span) & (jnp.max(state[8]) > 0.0)

            def step(c):
                b, state = c
                return b + 1, bounce(b, state)

            _, st = jax.lax.while_loop(live, step, (jnp.int32(0), (
                ox, oy, oz, dx, dy, dz, [one] * 4, [zero] * 4, in_image,
                segs, seed)))
            inc = st[7]
            return [acc[c] + inc[c] for c in range(4)], st[9], st[10]

        zero = jnp.zeros(SHAPE, jnp.float32)
        acc, segs, _ = jax.lax.fori_loop(0, rpp, sample,
                                         ([zero] * 4, zero, seed0))
        inv = np.float32(1.0 / rpp)
        or_ref[...] = acc[0] * inv
        og_ref[...] = acc[1] * inv
        ob_ref[...] = acc[2] * inv
        oa_ref[...] = acc[3] * inv
        seg_ref[...] = segs

    return kernel


def _pack_tables(scene: RenderScene):
    """Sphere table (S_pad, 8), WORLD-space triangle table (T_pad, 16) and
    winner-field table (S_pad + T_pad + 1, N_FIELDS). Traced-friendly (runs
    under jit): jnp ops only, static shapes from the scene's array shapes
    and its static inst_spans tuple."""
    hi = jax.lax.Precision.HIGHEST
    S = scene.n_spheres
    S_pad = _padded(S)
    T = _tri_count(scene)
    T_pad = _padded(T)
    C = S_pad + T_pad

    sph = jnp.zeros((S_pad, 8), jnp.float32)
    sph = sph.at[:, 0].set(1e30)  # dummy spheres can never be hit
    sph = sph.at[:S, 0:3].set(scene.sphere_pos)
    sph = sph.at[:S, 3].set(scene.sphere_radius)
    # col 4: K = |c|² - r² for the shared-term pass (sphere_fast_min);
    # EXACT op order of intersect.ray_sphere_fast's in-trace ck
    # (jnp.sum reduction over 3 = ((xx+yy)+zz)) so XLA/Pallas agree
    # bit-for-bit. Dummy rows overflow to inf → disc ends -inf/NaN →
    # the hit gate rejects them (no finite sentinel needed).
    p = sph[:, 0:3]
    sph = sph.at[:, 4].set(jnp.sum(p * p, axis=1) - sph[:, 3] * sph[:, 3])

    fld = jnp.zeros((C + 1, N_FIELDS), jnp.float32)   # row C: misses
    if S:
        fld = fld.at[:S, :32].set(jnp.take(scene.mat_rows, scene.sphere_mat,
                                           axis=0))
        fld = fld.at[:S, F_PX:F_PX + 3].set(scene.sphere_pos)

    # ---- triangles baked to WORLD space (no per-ray instance math) ------
    # Rows T..T_pad stay zero: a zero geometric normal gives det == 0,
    # which ray_triangle's keep-gate rejects — dummies can never be hit.
    tri = jnp.zeros((T_pad, 16), jnp.float32)
    if T:
        v0l, v1l, v2l, n0l, n1l, n2l, matl = [], [], [], [], [], [], []
        for i, (_n, toff, cnt) in enumerate(scene.inst_spans):
            if cnt == 0:
                continue
            m2w = scene.inst_model_to_world[i]
            R, t = m2w[:3, :3], m2w[:3, 3]
            sl = slice(toff, toff + cnt)
            v0w = jnp.dot(scene.tri_v0[sl], R.T, precision=hi) + t
            v1w = jnp.dot(scene.tri_v1[sl], R.T, precision=hi) + t
            v2w = jnp.dot(scene.tri_v2[sl], R.T, precision=hi) + t
            # a reflecting transform (det < 0) flips winding: swap v1/v2
            # (and the matching vertex normals) so backface/cull semantics
            # track the model-space orientation
            detR = (R[0, 0] * (R[1, 1] * R[2, 2] - R[1, 2] * R[2, 1])
                    - R[0, 1] * (R[1, 0] * R[2, 2] - R[1, 2] * R[2, 0])
                    + R[0, 2] * (R[1, 0] * R[2, 1] - R[1, 1] * R[2, 0]))
            neg = detR < 0.0
            n0w = jnp.dot(scene.tri_n0[sl], R.T, precision=hi)
            n1w = jnp.dot(scene.tri_n1[sl], R.T, precision=hi)
            n2w = jnp.dot(scene.tri_n2[sl], R.T, precision=hi)
            v0l.append(v0w)
            v1l.append(jnp.where(neg, v2w, v1w))
            v2l.append(jnp.where(neg, v1w, v2w))
            n0l.append(n0w)
            n1l.append(jnp.where(neg, n2w, n1w))
            n2l.append(jnp.where(neg, n1w, n2w))
            matl.append(scene.tri_mat[sl] + scene.inst_mat_deltas[i])
        v0 = jnp.concatenate(v0l)
        e1 = jnp.concatenate(v1l) - v0
        e2 = jnp.concatenate(v2l) - v0
        mats = jnp.concatenate(matl)
        cull = (jnp.take(scene.materials.flag, mats) != 1)
        tri = tri.at[:T, 0:3].set(v0)
        tri = tri.at[:T, 3:6].set(e1)
        tri = tri.at[:T, 6:9].set(e2)
        tri = tri.at[:T, 9:12].set(jnp.cross(e1, e2))
        tri = tri.at[:T, 12].set(cull.astype(jnp.float32))
        rows = slice(S_pad, S_pad + T)
        fld = fld.at[rows, :32].set(jnp.take(scene.mat_rows, mats, axis=0))
        fld = fld.at[rows, F_N0:F_N0 + 3].set(jnp.concatenate(n0l))
        fld = fld.at[rows, F_N0 + 3:F_N0 + 6].set(jnp.concatenate(n1l))
        fld = fld.at[rows, F_N0 + 6:F_N0 + 9].set(jnp.concatenate(n2l))
    return sph, tri, fld, S_pad, T_pad


@functools.partial(jax.jit, static_argnames=(
    "width", "height", "bounces", "rays_per_pixel", "skybox", "rows",
    "row_start", "interpret"))
def render_spheres_pallas(scene: RenderScene, frames, *, width: int,
                          height: int, bounces: int, rays_per_pixel: int,
                          skybox: bool, row_start: int = 0,
                          rows: int | None = None, interpret: bool = False):
    """Whole-image small-scene render. Returns ((rows, width, 4),
    segments). Same RNG streams as the tiled/megakernel paths.
    ``interpret`` runs the Pallas interpreter (tests on CPU only)."""
    rows = height if rows is None else rows
    total = rows * width
    rpp = max(rays_per_pixel, 1)
    n_blocks = -(-total // BLOCK)

    sph, tri, fld, S_pad, T_pad = _pack_tables(scene)
    cam = scene.cam_to_world
    cam_c = jnp.concatenate([
        cam[:3, :3].reshape(-1), cam[:3, 3], scene.view_params,
        (scene.defocus_strength / width)[None],
        (scene.diverge_strength / width)[None],
        jnp.asarray([jnp.float32(height)]),
    ])
    kernel = _make_kernel(scene.n_spheres, S_pad, _tri_count(scene), T_pad,
                          bounces, rpp, skybox, width, total, int(row_start))
    whole = pl.BlockSpec()   # whole array, indexed in-kernel
    px_spec = pl.BlockSpec((BLOCK,), lambda i: (i,))
    px_shape = jax.ShapeDtypeStruct((n_blocks * BLOCK,), jnp.float32)
    r, g, b, a, segs = pl.pallas_call(
        kernel,
        grid=(n_blocks,),
        in_specs=[whole] * 5,
        out_specs=(px_spec,) * 5,
        out_shape=(px_shape,) * 5,
        backend="triton",
        compiler_params=pl_triton.CompilerParams(num_warps=NUM_WARPS,
                                                 num_stages=1),
        interpret=interpret,
        name="pallas_spheres",
    )(jnp.asarray(frames, jnp.int32).reshape(1), cam_c, sph, tri, fld)
    img = jnp.stack([r, g, b, a], axis=1)[:total].reshape(rows, width, 4)
    return img, jnp.sum(segs[:total])

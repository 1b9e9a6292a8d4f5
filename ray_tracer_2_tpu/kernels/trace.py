"""Path-trace kernel: camera rays → collision → shading → radiance.

This is the vectorized re-design of the reference megakernel
(shaders/ray_tracer.wgsl). One call traces a flat batch of pixels; the engine
tiles the framebuffer into batches and ``shard_map`` tiles batches across
chips. Everything is branch-free masked vector code over SoA arrays; the only
loops are the bounce ``while_loop`` (exits when every ray in the batch died)
and the lockstep BVH walk in kernels/traverse.py.

Physics parity map (WGSL line refs):
  environment light  :214-221   glass branch         :414-436
  camera rays        :473-500   diffuse/specular     :437-459
  bounce loop        :398-471   russian roulette     :462-466
  debug modes        :502-573   accumulation         :144-162 (engine)
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ray_tracer_2_tpu import rng
from ray_tracer_2_tpu.kernels.gatherlib import fetch_attr, fetch_rows
from ray_tracer_2_tpu.kernels.intersect import (
    INF, ray_sphere, sphere_normal_uv,
)
from ray_tracer_2_tpu.kernels.texture import sample_texture
from ray_tracer_2_tpu.kernels.traverse import traverse_bvh
from ray_tracer_2_tpu.math.vec import dot, lerp, normalize, reflect, refract, smoothstep
from ray_tracer_2_tpu.scene.render_scene import RenderScene

# Sky constants (ray_tracer.wgsl:126-130)
SKY_HORIZON = jnp.array([1.0, 1.0, 1.0, 0.0], jnp.float32)
SKY_ZENITH = jnp.array([0.0788092, 0.36480793, 0.7264151, 0.0], jnp.float32)
GROUND_COLOR = jnp.array([0.35, 0.3, 0.35, 0.0], jnp.float32)
SUN_INTENSITY = jnp.float32(0.1)
SUN_FOCUS = jnp.float32(500.0)

GLASS = 1
TEXTURE = 2
#: full float32 products (a GPU may otherwise run them in TF32)
HIGHEST = jax.lax.Precision.HIGHEST


def environment_light(direction):
    """Two-band sky gradient + sun + ground (ray_tracer.wgsl:214-221)."""
    y = direction[..., 1]
    sky_t = smoothstep(0.0, 0.4, y) ** 0.35
    ground_to_sky = smoothstep(-0.01, 0.0, y)
    sky = lerp(SKY_HORIZON, SKY_ZENITH, sky_t[..., None])
    sun_dir = jnp.array([0.1, 1.0, 0.1], jnp.float32)
    sun = jnp.maximum(0.0, dot(direction, sun_dir)) ** SUN_FOCUS * SUN_INTENSITY
    comp = lerp(GROUND_COLOR, sky, ground_to_sky[..., None])
    return comp + (sun * (ground_to_sky >= 1.0))[..., None]


def _mat4_apply(m, v, w):
    """Apply a (4,4) matrix to (B,3) points (w=1) or vectors (w=0)."""
    out = jnp.dot(v, m[:3, :3].T, precision=HIGHEST)
    return out + m[:3, 3] if w else out


def compute_hit(scene: RenderScene, origin, direction, inv_dir):
    """Closest hit over all spheres and all instance-group BVHs
    (ray_tracer.wgsl:353-396). Returns per-ray hit record + traversal stats."""
    B = origin.shape[0]
    best_dst = jnp.full((B,), INF)
    hit_any = jnp.zeros((B,), bool)
    point = origin + direction  # placeholder
    normal = jnp.zeros((B, 3))
    uv = jnp.zeros((B, 2))
    backface = jnp.zeros((B,), bool)
    mat_id = jnp.zeros((B,), jnp.int32)
    stats = jnp.zeros((B, 2), jnp.int32)

    # ---- spheres: broadcast (B, S), winner via one-hot reduce ---------
    if scene.n_spheres > 0:
        S = scene.n_spheres
        s_hit, s_dst, s_inside = ray_sphere(
            origin[:, None, :], direction[:, None, :],
            scene.sphere_pos[None, :, :], scene.sphere_radius[None, :])
        idx = jnp.argmin(s_dst, axis=1)
        is_win = jnp.arange(S, dtype=jnp.int32)[None, :] == idx[:, None]
        dst = jnp.sum(jnp.where(is_win, s_dst, 0.0), axis=1)
        inside = jnp.any(is_win & s_inside, axis=1)
        won = jnp.any(is_win & s_hit, axis=1) & (dst < best_dst)
        centre = jnp.dot(is_win.astype(jnp.float32), scene.sphere_pos,
                         precision=jax.lax.Precision.HIGHEST)
        hp = origin + direction * dst[:, None]
        n, s_uv = sphere_normal_uv(hp, centre, inside)
        best_dst = jnp.where(won, dst, best_dst)
        hit_any = hit_any | won
        point = jnp.where(won[:, None], hp, point)
        normal = jnp.where(won[:, None], n, normal)
        uv = jnp.where(won[:, None], s_uv, uv)
        backface = jnp.where(won, inside, backface)
        s_mat = jnp.sum(jnp.where(is_win, scene.sphere_mat[None, :], 0), axis=1)
        mat_id = jnp.where(won, s_mat, mat_id)

    # ---- instance groups (ray_tracer.wgsl:369-393): brute-force the small
    # ones (zero gathers), BVH-traverse the big ones ---------------------
    if scene.n_instances > 0:
        from ray_tracer_2_tpu.kernels.brute import brute_force_intersect, brute_max
        from ray_tracer_2_tpu.kernels.traverse import traverse_bvh

        m_tri = jnp.full((B,), -1, jnp.int32)
        m_u = jnp.zeros((B,))
        m_v = jnp.zeros((B,))
        m_det = jnp.zeros((B,))
        m_mat = jnp.zeros((B,), jnp.int32)
        m_inst = jnp.zeros((B,), jnp.int32)
        m_point = point
        m_dst = jnp.full((B,), INF)
        for i in range(scene.n_instances):
            node_off, tri_off, tri_count = scene.inst_spans[i]
            w2m = scene.inst_world_to_model[i]
            m2w = scene.inst_model_to_world[i]
            o_m = _mat4_apply(w2m, origin, 1)
            d_raw = _mat4_apply(w2m, direction, 0)
            d_m = normalize(d_raw)
            if tri_count <= brute_max():
                res = brute_force_intersect(scene, o_m, d_m, tri_off, tri_count)
            else:
                res = traverse_bvh(scene, o_m, d_m, 1.0 / d_m, node_off,
                                   tri_off)
            stats = stats + res["stats"]
            got = res["tri"] >= 0
            local_hp = o_m + d_m * res["dst"][:, None]
            world_hp = _mat4_apply(m2w, local_hp, 1)
            world_dst = jnp.sqrt(dot(world_hp - origin, world_hp - origin))
            better = got & (world_dst < m_dst)
            m_dst = jnp.where(better, world_dst, m_dst)
            m_tri = jnp.where(better, res["tri"], m_tri)
            m_u = jnp.where(better, res["u"], m_u)
            m_v = jnp.where(better, res["v"], m_v)
            m_det = jnp.where(better, res["det"], m_det)
            m_mat = jnp.where(better,
                              res["mat"] + scene.inst_mat_deltas[i], m_mat)
            m_inst = jnp.where(better, i, m_inst)
            m_point = jnp.where(better[:, None], world_hp, m_point)

        mesh_better = (m_tri >= 0) & (m_dst < best_dst)
        # Winner attributes: one packed row (normals+uvs), one matrix gather.
        safe_tri = jnp.maximum(m_tri, 0)
        attr = fetch_attr(scene.tri_attr, safe_tri)  # (B, 32)
        m2w_sel = jnp.take(scene.inst_model_to_world, m_inst, axis=0)
        det = m_det
        w_bar = 1.0 - m_u - m_v
        n_model = normalize(attr[:, 0:3] * w_bar[:, None]
                            + attr[:, 3:6] * m_u[:, None]
                            + attr[:, 6:9] * m_v[:, None]) * jnp.sign(det)[:, None]
        n_world = normalize(jnp.einsum("bij,bj->bi", m2w_sel[:, :3, :3],
                                       n_model, precision=HIGHEST))
        m_uv = (attr[:, 9:11] * w_bar[:, None] + attr[:, 11:13] * m_u[:, None]
                + attr[:, 13:15] * m_v[:, None])

        best_dst = jnp.where(mesh_better, m_dst, best_dst)
        hit_any = hit_any | mesh_better
        point = jnp.where(mesh_better[:, None], m_point, point)
        normal = jnp.where(mesh_better[:, None], n_world, normal)
        uv = jnp.where(mesh_better[:, None], m_uv, uv)
        backface = jnp.where(mesh_better, det < 0.0, backface)
        mat_id = jnp.where(mesh_better, m_mat, mat_id)

    return dict(hit=hit_any, dst=best_dst, point=point, normal=normal, uv=uv,
                backface=backface, mat_id=mat_id, stats=stats)


def _gather_material(scene: RenderScene, mat_id):
    """One packed-row fetch resolves every material field for shading
    (layout: render_scene._pack_material_rows; one-hot matmul for the
    usual small tables)."""
    row = fetch_rows(scene.mat_rows, mat_id)  # (B, 32)
    return dict(
        color=row[:, 0:4], emission_color=row[:, 4:8],
        specular_color=row[:, 8:12], absorption=row[:, 12:16],
        absorption_strength=row[:, 16], emission_strength=row[:, 17],
        smoothness=row[:, 18], specular=row[:, 19], ior=row[:, 20],
        flag=row[:, 21].astype(jnp.int32),
        diffuse_index=row[:, 22].astype(jnp.int32),
        normal_index=row[:, 23].astype(jnp.int32),
    )


def _reflectance(cos_theta, ior):
    """Schlick (ray_tracer.wgsl:208-212)."""
    r0 = (1.0 - ior) / (1.0 + ior)
    r0 = r0 * r0
    return r0 + (1.0 - r0) * (1.0 - cos_theta) ** 5


def trace_batch(scene: RenderScene, origin, direction, seed, *,
                bounces: int, skybox: bool):
    """The bounce loop (ray_tracer.wgsl:398-471) for a batch of rays.
    Returns (incoming_light (B,4), seed, segments (B,) int32) — ``segments``
    counts traced ray segments (1 per live bounce iteration) for exact
    Mrays/s accounting."""
    B = origin.shape[0]
    direction = normalize(direction)
    # State fused into two packed carries + the bounce counter:
    #   F (B, 14) f32: origin3 | direction3 | transmittance4 | incoming4
    #   I (B, 4) i32: seed bits | alive | segments | pad
    F0 = jnp.concatenate([origin, direction, jnp.ones((B, 4)),
                          jnp.zeros((B, 4))], axis=1)
    I0 = jnp.stack([jax.lax.bitcast_convert_type(seed, jnp.int32),
                    jnp.ones((B,), jnp.int32), jnp.zeros((B,), jnp.int32),
                    jnp.zeros((B,), jnp.int32)], axis=1)

    def cond(state):
        i, _, I = state
        return (i <= bounces) & jnp.any(I[:, 1] > 0)

    def body(state):
        i, F, I = state
        o, d = F[:, 0:3], F[:, 3:6]
        trans, incoming = F[:, 6:10], F[:, 10:14]
        seed = jax.lax.bitcast_convert_type(I[:, 0], jnp.uint32)
        alive = I[:, 1] > 0
        entry_alive = alive  # a miss segment is still a traced segment
        segments = I[:, 2]
        hit = compute_hit(scene, o, d, 1.0 / d)

        # Miss: environment light, then die (ray_tracer.wgsl:406-412).
        missed = alive & ~hit["hit"]
        if skybox:
            incoming = jnp.where(missed[:, None],
                                 incoming + trans * environment_light(d), incoming)
        alive = alive & hit["hit"]

        m = _gather_material(scene, hit["mat_id"])
        is_glass = m["flag"] == GLASS
        normal = hit["normal"]
        backface = hit["backface"]

        # ---------------- glass branch (ray_tracer.wgsl:414-436) ----------
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
        # WGSL `||` short-circuits: the rand is only drawn when refraction is
        # possible — mirror that for stream parity (ray_tracer.wgsl:428).
        r_refl, seed_refl = rng.rand(seed)
        seed_g = jnp.where(cannot_refract, seed, seed_refl)
        follow_reflection = cannot_refract | (_reflectance(cos_theta, ior) > r_refl)
        rand_dir_g, seed_g = rng.rand_direction(seed_g)
        diffuse_g = normalize(normal + rand_dir_g)
        reflect_mix = normalize(lerp(diffuse_g, reflect_dir, m["specular"][:, None]))
        refract_mix = normalize(lerp(-diffuse_g, refract_dir, m["smoothness"][:, None]))
        dir_g = jnp.where(follow_reflection[:, None], reflect_mix, refract_mix)
        origin_g = hit["point"] + 1e-4 * normal * jnp.sign(dot(normal, dir_g))[:, None]

        # ------------- diffuse/specular branch (ray_tracer.wgsl:437-459) --
        r_spec, seed_n = rng.rand(seed)
        is_specular = m["specular"] >= r_spec
        diffuse_n, seed_n = rng.rand_hemisphere(normal, seed_n)
        specular_dir = reflect(d, normal)
        emitted = m["emission_color"] * m["emission_strength"][:, None]
        dir_n = normalize(lerp(diffuse_n, specular_dir,
                               (m["smoothness"] * is_specular)[:, None]))
        incoming_n = incoming + emitted * trans
        textured = (m["flag"] == TEXTURE) & (m["diffuse_index"] != -1)
        tex_color = sample_texture(scene, m["diffuse_index"], hit["uv"])
        color = jnp.where(textured[:, None], tex_color, m["color"])
        trans_n = trans * jnp.where(is_specular[:, None], m["specular_color"], color)

        # ---------------- select branch, then russian roulette ------------
        g = is_glass[:, None]
        new_dir = jnp.where(g, dir_g, dir_n)
        new_origin = jnp.where(g, origin_g, hit["point"])
        new_trans = jnp.where(g, trans_g, trans_n)
        new_incoming = jnp.where(is_glass[:, None] | ~alive[:, None],
                                 incoming, incoming_n)
        new_seed = jnp.where(is_glass, seed_g, seed_n)

        p = jnp.max(new_trans[:, :3], axis=1)
        r_rr, new_seed = rng.rand(new_seed)
        survive = r_rr < p
        new_trans = new_trans / jnp.where(p > 0.0, p, 1.0)[:, None]

        # Only live rays advance their state/seed.
        live = alive[:, None]
        F_new = jnp.concatenate([
            jnp.where(live, new_origin, o),
            jnp.where(live, new_dir, d),
            jnp.where(live, new_trans, trans),
            new_incoming], axis=1)
        I_new = jnp.stack([
            jax.lax.bitcast_convert_type(
                jnp.where(alive, new_seed, seed), jnp.int32),
            (alive & survive).astype(jnp.int32),
            segments + entry_alive.astype(jnp.int32),
            I[:, 3]], axis=1)
        return i + 1, F_new, I_new

    _, F, I = jax.lax.while_loop(cond, body, (jnp.int32(0), F0, I0))
    return (F[:, 10:14],
            jax.lax.bitcast_convert_type(I[:, 0], jnp.uint32),
            I[:, 2])


def camera_ray_basis(scene: RenderScene, x, y, width: int, height: int):
    """Shared camera-ray setup (ray_tracer.wgsl:479-485)."""
    size = jnp.array([width, height], jnp.float32)
    pos = jnp.stack([x.astype(jnp.float32), y.astype(jnp.float32)], axis=-1)
    # max(…, 1): the reference divides by size-1 (ray_tracer.wgsl:479), which
    # NaNs a 1-pixel-wide render; guard without changing any real size.
    uv = pos / jnp.maximum(size - 1.0, 1.0)
    local_focus = jnp.stack([
        (uv[:, 0] - 0.5) * scene.view_params[0],
        (uv[:, 1] - 0.5) * scene.view_params[1],
        jnp.full_like(uv[:, 0], scene.view_params[2]),
    ], axis=-1)
    m = scene.cam_to_world
    focus_point = jnp.dot(local_focus, m[:3, :3].T, precision=HIGHEST) \
        + m[:3, 3]
    cam_origin = m[:3, 3]
    cam_right = m[:3, 0]
    cam_up = m[:3, 1]
    return cam_origin, cam_right, cam_up, focus_point


def trace_pixels(scene: RenderScene, x, y, frames, *,
                 width: int, height: int, bounces: int,
                 rays_per_pixel: int, skybox: bool,
                 antialias: bool = False):
    """Full per-pixel sample — frag() (ray_tracer.wgsl:473-500).

    x, y: (B,) int32 pixel coordinates; frames: scalar int32 (RNG stream id).
    Returns ((B, 4) radiance averaged over rays_per_pixel,
             (B,) traced segment counts).

    ``antialias`` adds a per-sample box-filter jitter over the pixel
    footprint (two uniform draws BEFORE the defocus/diverge draws — the
    megakernel path mirrors the order exactly, so both paths stay
    draw-for-draw identical to each other with the flag on).
    """
    cam_origin, cam_right, cam_up, focus_point = camera_ray_basis(
        scene, x, y, width, height)
    pixel_index = (y * width + x).astype(jnp.uint32)
    seed0 = rng.seed_for_pixel(pixel_index, frames)
    inv_size_x = 1.0 / jnp.float32(width)

    # Scenes with at least one BVH instance use the flat megakernel state
    # machine (kernels/megakernel.py) — no per-bounce lockstep barriers;
    # brute-force/sphere-only scenes keep the simple layered loop.
    from ray_tracer_2_tpu.kernels.megakernel import (
        _bvh_instances, trace_batch_flat,
    )
    tracer = (trace_batch_flat if _bvh_instances(scene) else trace_batch)

    def sample_once(carry, _):
        seed, total, segs = carry
        fp0 = focus_point
        if antialias:
            ju, seed = rng.rand(seed)
            jv, seed = rng.rand(seed)
            du = (ju - 0.5) * scene.view_params[0] / max(width - 1, 1)
            dv = (jv - 0.5) * scene.view_params[1] / max(height - 1, 1)
            fp0 = fp0 + cam_right * du[:, None] + cam_up * dv[:, None]
        dj, seed = rng.rand_in_unit_disk(seed)
        dj = dj * scene.defocus_strength * inv_size_x
        origin = cam_origin + cam_right * dj[:, :1] + cam_up * dj[:, 1:]
        vj, seed = rng.rand_in_unit_disk(seed)
        vj = vj * scene.diverge_strength * inv_size_x
        fp = fp0 + cam_right * vj[:, :1] + cam_up * vj[:, 1:]
        direction = normalize(fp - origin)
        light, seed, seg = tracer(scene, origin, direction, seed,
                                  bounces=bounces, skybox=skybox)
        return (seed, total + light, segs + seg), None

    B = x.shape[0]
    init = (seed0, jnp.zeros((B, 4)), jnp.zeros((B,), jnp.int32))
    (seed, total, segs), _ = jax.lax.scan(sample_once, init, None,
                                          length=max(rays_per_pixel, 1))
    return total / jnp.float32(max(rays_per_pixel, 1)), segs


def debug_trace_pixels(scene: RenderScene, x, y, *, width: int, height: int,
                       debug_mode: int, debug_scale):
    """Deterministic single-ray debug render (ray_tracer.wgsl:502-573).
    debug_scale is a traced scalar so UI slider changes don't re-jit."""
    cam_origin, _, _, focus_point = camera_ray_basis(scene, x, y, width, height)
    B = x.shape[0]
    origin = jnp.broadcast_to(cam_origin, (B, 3))
    direction = normalize(focus_point - origin)
    hit = compute_hit(scene, origin, direction, 1.0 / direction)

    scale = jnp.float32(debug_scale)
    ones = jnp.ones((B,))
    zeros4 = jnp.zeros((B, 4))
    hit_mask = hit["hit"][:, None]

    def grey(v):
        return jnp.stack([v, v, v, ones], axis=-1)

    mode = int(debug_mode)
    if mode == 1:  # normals (normal-map texel preview when mapped,
        # ray_tracer.wgsl:542-548 — note 0.5*(2x-1)+0.5 ≡ x)
        m = _gather_material(scene, hit["mat_id"])
        mapped = (m["flag"] == TEXTURE) & (m["normal_index"] != -1)
        tex = sample_texture(scene, m["normal_index"], hit["uv"])
        n = jnp.where(mapped[:, None], tex[:, :3], hit["normal"] * 0.5 + 0.5)
        out = jnp.concatenate([n, ones[:, None]], axis=1)
        return jnp.where(hit_mask, out, zeros4)
    if mode == 2:  # depth
        return jnp.where(hit_mask, grey(hit["dst"] / scale), zeros4)
    if mode == 3:  # tex coords
        out = jnp.concatenate([hit["uv"], jnp.zeros((B, 1)), ones[:, None]], axis=1)
        return jnp.where(hit_mask, out, zeros4)
    if mode == 4:  # focus distance
        s = scale / 100.0
        d = hit["dst"]
        green = jnp.stack([jnp.zeros_like(d), ones, jnp.zeros_like(d), ones], axis=-1)
        return jnp.where(hit_mask, jnp.where((d > s)[:, None], green, grey(d)), zeros4)
    if mode == 5:  # node tests heatmap
        dd = hit["stats"][:, 0].astype(jnp.float32) / scale
        red = jnp.stack([ones, 0 * ones, 0 * ones, ones], axis=-1)
        return jnp.where((dd > 1.0)[:, None], red, grey(dd))
    if mode == 6:  # triangle tests heatmap
        t = hit["stats"][:, 1].astype(jnp.float32) / scale
        red = jnp.stack([ones, 0 * ones, 0 * ones, ones], axis=-1)
        return jnp.where((t > 1.0)[:, None], red, grey(t))
    if mode == 7:  # nodes + triangles
        dd = hit["stats"][:, 0].astype(jnp.float32) / scale
        t = hit["stats"][:, 1].astype(jnp.float32) / scale
        return jnp.stack([t, 0 * ones, dd, ones], axis=-1)
    # default: magenta (ray_tracer.wgsl:569-571)
    return jnp.stack([ones, 0 * ones, ones, ones], axis=-1)

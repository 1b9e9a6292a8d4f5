"""Scalar numpy path-tracing oracle.

An independent, deliberately naive scalar implementation of the reference
kernel's semantics (shaders/ray_tracer.wgsl) — one ray at a time, float32,
same RNG stream. Used to validate the vectorized kernels draw-for-draw on
sphere scenes. Slow by construction; tests use a handful of pixels.
"""
from __future__ import annotations

import numpy as np

M32 = 0xFFFFFFFF
F = np.float32
PI = F(3.1415926)
INF = F(1.7014118e38)


class Rng:
    def __init__(self, seed: int):
        self.seed = seed & M32

    def next_u32(self) -> int:
        self.seed = (self.seed * 747796405 + 2891336453) & M32
        shift = ((self.seed >> 28) + 4) & M32
        r = (((self.seed >> shift) ^ self.seed) * 277803737) & M32
        return ((r >> 22) ^ r) & M32

    def rand(self) -> F:
        return F(self.next_u32()) / F(4294967295.0)

    def normal(self) -> F:
        theta = F(2.0) * PI * self.rand()
        rho = np.sqrt(F(-2.0) * np.log(self.rand()))
        return F(rho * np.cos(theta))

    def direction(self):
        v = np.array([self.normal(), self.normal(), self.normal()], F)
        return v / np.linalg.norm(v).astype(F)

    def hemisphere(self, n):
        d = self.direction()
        return d * np.sign(np.dot(n, d)).astype(F)

    def disk(self):
        angle = self.rand() * F(2.0) * PI
        p = np.array([np.cos(angle), np.sin(angle)], F)
        return p * np.sqrt(self.rand())


def normalize(v):
    return (v / np.linalg.norm(v)).astype(F)


def reflect(i, n):
    return (i - 2 * np.dot(i, n) * n).astype(F)


def refract(i, n, eta):
    cos_i = np.dot(n, i)
    k = 1.0 - eta * eta * (1.0 - cos_i * cos_i)
    if k < 0.0:
        return np.zeros(3, F)
    return (eta * i - (eta * cos_i + np.sqrt(k)) * n).astype(F)


def smoothstep(e0, e1, x):
    t = np.clip((x - e0) / (e1 - e0), 0.0, 1.0)
    return F(t * t * (3 - 2 * t))


def env_light(d):
    sky_t = smoothstep(0.0, 0.4, d[1]) ** F(0.35)
    g2s = smoothstep(-0.01, 0.0, d[1])
    horizon = np.array([1, 1, 1, 0], F)
    zenith = np.array([0.0788092, 0.36480793, 0.7264151, 0], F)
    ground = np.array([0.35, 0.3, 0.35, 0], F)
    sky = horizon + (zenith - horizon) * sky_t
    sun = max(0.0, np.dot(d, np.array([0.1, 1.0, 0.1], F))) ** 500 * 0.1
    comp = ground + (sky - ground) * g2s
    return (comp + sun * (1.0 if g2s >= 1.0 else 0.0)).astype(F)


def ray_sphere(o, d, centre, radius):
    oc = (o - centre).astype(F)
    a = np.dot(d, d)
    b = F(2.0) * np.dot(oc, d)
    c = np.dot(oc, oc) - radius * radius
    disc = b * b - 4 * a * c
    if disc < 0:
        return None
    s = np.sqrt(disc)
    dst_near = max(F(0.0), (-b - s) / (2 * a))
    dst_far = (-b + s) / (2 * a)
    if dst_far < 0.001:
        return None
    inside = dst_near == 0.0
    dst = dst_far if inside else dst_near
    hp = (o + d * dst).astype(F)
    n = normalize(hp - centre)
    if inside:
        n = -n
    return dict(dst=F(dst), point=hp, normal=n, backface=bool(inside))


def reflectance(cos_theta, ior):
    r0 = (1 - ior) / (1 + ior)
    r0 = r0 * r0
    return F(r0 + (1 - r0) * (1 - cos_theta) ** 5)


def ray_triangle(o, d, v0, v1, v2, cull):
    """Scalar Möller–Trumbore, mirroring kernels/intersect.py:54-76."""
    edge_ab = (v1 - v0).astype(F)
    edge_ac = (v2 - v0).astype(F)
    normal = np.cross(edge_ab, edge_ac).astype(F)
    ao = (o - v0).astype(F)
    dao = np.cross(ao, d).astype(F)
    det = F(-np.dot(d, normal))
    keep = det >= 1e-8 if cull else abs(det) >= 1e-8
    if not keep:
        return None
    inv_det = F(1.0) / det
    dst = F(np.dot(ao, normal) * inv_det)
    u = F(np.dot(edge_ac, dao) * inv_det)
    v = F(-np.dot(edge_ab, dao) * inv_det)
    w = F(1.0 - u - v)
    if not (dst > F(1e-5) and u >= 0.0 and v >= 0.0 and w >= 0.0):
        return None
    return dict(dst=dst, u=u, v=v, det=det)


def closest_hit(spheres, o, d, meshes=()):
    """World-space closest hit over spheres + mesh instances. Within an
    instance the winner is the model-space closest (megakernel.py
    advance_instance / segment_prepass semantics); across primitives the
    comparison is the WORLD-space distance."""
    best = None
    for s in spheres:
        h = ray_sphere(o, d, s["pos"], s["radius"])
        if h is not None and (best is None or h["dst"] < best["dst"]):
            h["mat"] = s["mat"]
            best = h
    for inst in meshes:
        w2m, m2w = inst["w2m"], inst["m2w"]
        o_m = (w2m[:3, :3] @ o + w2m[:3, 3]).astype(F)
        d_m = normalize((w2m[:3, :3] @ d).astype(F))
        ibest = None
        for t in inst["tris"]:
            h = ray_triangle(o_m, d_m, t["v0"], t["v1"], t["v2"], t["cull"])
            if h is not None and (ibest is None or h["dst"] < ibest["dst"]):
                h["tri"] = t
                ibest = h
        if ibest is None:
            continue
        local_hp = (o_m + d_m * ibest["dst"]).astype(F)
        world_hp = (m2w[:3, :3] @ local_hp + m2w[:3, 3]).astype(F)
        world_dst = F(np.linalg.norm(world_hp - o))
        if best is not None and world_dst >= best["dst"]:
            continue
        t = ibest["tri"]
        u, v = ibest["u"], ibest["v"]
        w = F(1.0 - u - v)
        n_model = normalize((t["n0"] * w + t["n1"] * u + t["n2"] * v
                             ).astype(F)) * np.sign(ibest["det"]).astype(F)
        n_world = normalize((m2w[:3, :3] @ n_model).astype(F))
        best = dict(dst=world_dst, point=world_hp, normal=n_world,
                    backface=bool(ibest["det"] < 0.0), mat=t["mat"])
    return best


def trace(spheres, o, d, rng: Rng, bounces: int, skybox: bool, meshes=()):
    d = normalize(d)
    trans = np.ones(4, F)
    incoming = np.zeros(4, F)
    for _ in range(bounces + 1):
        hit = closest_hit(spheres, o, d, meshes)
        if hit is None:
            if skybox:
                incoming += trans * env_light(d)
            break
        m = hit["mat"]
        o = hit["point"]
        n = hit["normal"]
        if m["flag"] == 1:  # glass
            if hit["backface"]:
                x = trans[:3] * np.exp(-hit["dst"] * m["absorption"][:3]
                                       * m["absorption_strength"])
                trans = np.array([x[0], x[1], x[2], 1.0], F)
            ior = m["ior"] if hit["backface"] else F(1.0 / m["ior"])
            refl = reflect(d, n)
            refr = refract(d, n, ior)
            cos_theta = min(np.dot(-d, n), F(1.0))
            sin_theta = np.sqrt(1 - cos_theta * cos_theta)
            cannot = ior * sin_theta > 1.0
            follow_refl = cannot or (reflectance(cos_theta, ior) > rng.rand())
            diffuse = normalize(n + rng.direction())
            refl = normalize(diffuse + (refl - diffuse) * m["specular"])
            refr = normalize(-diffuse + (refr + diffuse) * m["smoothness"])
            d = refl if follow_refl else refr
            o = hit["point"] + F(1e-4) * n * np.sign(np.dot(n, d)).astype(F)
        else:
            is_spec = m["specular"] >= rng.rand()
            diffuse = rng.hemisphere(n)
            spec_dir = reflect(d, n)
            emitted = m["emission_color"] * m["emission_strength"]
            mix_t = m["smoothness"] * (1.0 if is_spec else 0.0)
            d = normalize(diffuse + (spec_dir - diffuse) * mix_t)
            incoming += emitted * trans
            trans = trans * (m["specular_color"] if is_spec else m["color"])
        p = max(trans[0], max(trans[1], trans[2]))
        if rng.rand() >= p:
            break
        trans = (trans / p).astype(F)
    return incoming


def render_pixel(spheres, cam, x, y, width, height, frames, bounces,
                 rpp, skybox, meshes=()):
    """frag() (ray_tracer.wgsl:473-500)."""
    pixel_index = int(F(y) * F(width) + F(x))
    rng = Rng((pixel_index + abs(frames) * 719393) & M32)
    u = F(x) / F(width - 1)
    v = F(y) / F(height - 1)
    m = cam["cam_to_world"]
    lf = np.array([(u - 0.5) * cam["view_params"][0],
                   (v - 0.5) * cam["view_params"][1],
                   cam["view_params"][2]], F)
    fp = (m[:3, :3] @ lf + m[:3, 3]).astype(F)
    right, up, origin0 = m[:3, 0], m[:3, 1], m[:3, 3]
    total = np.zeros(4, F)
    for _ in range(rpp):
        dj = rng.disk() * cam["defocus_strength"] / F(width)
        o = (origin0 + right * dj[0] + up * dj[1]).astype(F)
        vj = rng.disk() * cam["diverge_strength"] / F(width)
        jf = (fp + right * vj[0] + up * vj[1]).astype(F)
        d = normalize(jf - o)
        total += trace(spheres, o, d, rng, bounces, skybox, meshes)
    return total / F(rpp)


def spheres_from_scene(rs) -> list[dict]:
    """Pull sphere + material data out of a RenderScene pytree."""
    return [dict(pos=np.asarray(rs.sphere_pos[i], F),
                 radius=F(rs.sphere_radius[i]),
                 mat=_material_dict(rs.materials, int(rs.sphere_mat[i])))
            for i in range(rs.n_spheres)]


def _material_dict(mats, mid: int) -> dict:
    return dict(
        color=np.asarray(mats.color[mid], F),
        emission_color=np.asarray(mats.emission_color[mid], F),
        specular_color=np.asarray(mats.specular_color[mid], F),
        absorption=np.asarray(mats.absorption[mid], F),
        absorption_strength=F(mats.absorption_strength[mid]),
        emission_strength=F(mats.emission_strength[mid]),
        smoothness=F(mats.smoothness[mid]),
        specular=F(mats.specular[mid]),
        ior=F(mats.ior[mid]),
        flag=int(mats.flag[mid]),
    )


def meshes_from_scene(rs) -> list[dict]:
    """Pull mesh instances (triangles in leaf order + transforms) out of a
    RenderScene pytree for the scalar oracle."""
    out = []
    v0 = np.asarray(rs.tri_v0, F)
    v1 = np.asarray(rs.tri_v1, F)
    v2 = np.asarray(rs.tri_v2, F)
    n0 = np.asarray(rs.tri_n0, F)
    n1 = np.asarray(rs.tri_n1, F)
    n2 = np.asarray(rs.tri_n2, F)
    tri_mat = np.asarray(rs.tri_mat)
    flags = np.asarray(rs.materials.flag)
    deltas = rs.inst_mat_deltas or (0,) * len(rs.inst_spans)
    for i, (_node_off, tri_off, count) in enumerate(rs.inst_spans):
        tris = []
        for t in range(tri_off, tri_off + count):
            mid = int(tri_mat[t]) + int(deltas[i])
            tris.append(dict(v0=v0[t], v1=v1[t], v2=v2[t],
                             n0=n0[t], n1=n1[t], n2=n2[t],
                             cull=bool(flags[mid] != 1),
                             mat=_material_dict(rs.materials, mid)))
        out.append(dict(w2m=np.asarray(rs.inst_world_to_model[i], F),
                        m2w=np.asarray(rs.inst_model_to_world[i], F),
                        tris=tris))
    return out


def camera_from_scene(rs) -> dict:
    return dict(cam_to_world=np.asarray(rs.cam_to_world, F),
                view_params=np.asarray(rs.view_params, F),
                defocus_strength=F(rs.defocus_strength),
                diverge_strength=F(rs.diverge_strength))

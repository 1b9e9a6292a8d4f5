"""RenderScene — the device-resident scene pytree, and scene instantiation.

The reference uploads AoS GPU buffers (spheres / packed triangles / mesh
uniforms / BVH nodes / texture array, ray_tracer.rs:164-195) every frame
(ray_tracer.rs:397-419). Here the scene is one immutable SoA pytree shipped to
the device **once per scene** (re-shipped only on edit), shaped for wide
vector ops:

  * triangles/nodes/materials/texels as flat structure-of-arrays;
  * per-triangle and per-sphere ``int32`` material ids into one deduplicated
    material table (the reference inlines a 112-byte material struct per
    primitive);
  * meshes sharing a world transform are merged into a single BVH ("instance
    groups") — the reference walks every sub-mesh linearly per ray
    (ray_tracer.wgsl:369-393); merging collapses e.g. Cornell Box's 8
    sub-meshes or sponza's hundreds into one traversal, with materials
    resolved per triangle.
"""
from __future__ import annotations

import dataclasses
import logging

import jax
import jax.numpy as jnp
import numpy as np

from ray_tracer_2_tpu.accel.bvh import BVH, BVHQuality, build_bvh
from ray_tracer_2_tpu.assets.textures import TextureAtlas, \
    pack_texels_u8_pairs, pack_texels_u8_quads
from ray_tracer_2_tpu.scene.camera import Camera
from ray_tracer_2_tpu.scene.definition import (
    MeshData, MeshFromData, MeshFromFile, SceneDefinition, SphereDef,
)
from ray_tracer_2_tpu.scene.material import MaterialRecord, MaterialTable

log = logging.getLogger(__name__)

#: Leaf triangle chunk width — leaves are built with <= this many triangles so
#: the traversal kernel intersects a whole leaf as one fixed-width vector op.
LEAF_CHUNK = 8

#: Sphere count above which the lit path traverses a sphere BVH instead of
#: the dense every-sphere cross (kernels/megakernel.py). Before the H100
#: port the dense cross won on random_balls (485 spheres): the boundary
#: phase is ungated, so the extra loop iterations the sphere phase adds
#: per segment cost more than the removed (B, S) quadratic cross. The
#: threshold is an extrapolation, queued for an H100 A/B (ROADMAP D2);
#: RT2_SPHERE_BVH=1 forces it on (tests do, for coverage).
SPHERE_BVH_MIN = 2048


def _sphere_bvh_engaged(n_spheres: int) -> bool:
    import os
    mode = os.environ.get("RT2_SPHERE_BVH", "auto")
    if mode == "0":
        return False
    if mode == "1":
        return n_spheres > 8  # root must be an internal wide row
    return n_spheres >= SPHERE_BVH_MIN


def _tex_quads() -> bool:
    """Texel-atlas layout choice (RT2_TEX_LAYOUT=quads|pairs, default
    quads): quad rows carry all four bilinear corners so a sample costs ONE
    row gather; pairs carry (y, y+1) and cost two. Env-selectable for
    A/Bs on the card — read at scene-instantiation time only."""
    import os
    return os.environ.get("RT2_TEX_LAYOUT", "quads") != "pairs"


def _tex_budget_mb() -> int:
    """Texel-atlas size budget in MB (RT2_TEX_BUDGET_MB, default 0 = OFF =
    full-resolution textures, matching the reference's in-kernel sampling,
    ray_tracer.wgsl:455-459). When set, oversized texture sets are
    downscaled at scene build to fit (assets/textures.py
    downsample_images_to_budget) — the lever for big-atlas scenes whose
    dependent texel gathers outgrow the caches (sponza: 168 MB). Read at
    scene-instantiation time only."""
    import os
    try:
        return max(int(os.environ.get("RT2_TEX_BUDGET_MB", "0")), 0)
    except ValueError:
        return 0


def _shade_classes(records) -> tuple:
    """Material-class summary for kernel specialization (STATIC pytree
    field): which shading branches can the scene ever take?"""
    classes = []
    if any(int(r.flag) == 1 for r in records):                   # GLASS
        classes.append("glass")
    textured = [int(r.flag) == 2 and r.diffuse_index != -1 for r in records]
    if any(textured):
        classes.append("texture")
        if sum(textured) * 2 >= len(records):
            # most materials textured: the megakernel inlines the bilinear
            # taps instead of gating them behind lax.cond (cond = barrier)
            classes.append("texture_dominant")
    if any(r.normal_index != -1 for r in records):
        classes.append("normal_map")
    return tuple(classes)


#: NEE is compiled out for scenes with more light primitives than this —
#: the sampler's one-hot pick table must stay a trivially-foldable constant.
MAX_NEE_LIGHTS = 64


def _extract_lights(records, tri, inst_spans, inst_m2w, inst_mat_deltas,
                    spheres) -> tuple:
    """Static emissive-primitive table for NEE (see RenderScene.lights).

    Emissive triangles come from EVERY instance (brute-force AND
    BVH-traversal ones — shadow-segment NEE suppresses surface emission
    after each diffuse bounce, so an emitter missing from this table would
    silently lose its energy), transformed to world space; spheres
    directly. Each row carries the RESOLVED radiance (emission_color *
    strength, the exact term the path tracer adds on a hit,
    ray_tracer.wgsl:452) and the world-space area that converts the
    uniform-over-total-area pdf. Scenes with more than MAX_NEE_LIGHTS
    emissive primitives return () — NEE compiles out entirely (never a
    truncated, energy-losing table)."""

    def emissive(rec):
        # GLASS surfaces never add their emission in the BSDF path (the
        # glass branch bypasses incoming_n, matching the reference) — an
        # emissive-glass material must not become an NEE light either
        return (rec.emission_strength > 0.0
                and max(rec.emission_color[:3]) > 0.0
                and int(rec.flag) != 1)

    def radiance(rec):
        return tuple(float(c) * float(rec.emission_strength)
                     for c in rec.emission_color[:3])

    emissive_ids = np.array([i for i, r in enumerate(records)
                             if emissive(r)], np.int64)
    if emissive_ids.size == 0 and not spheres:
        return ()
    lights = []
    tri_mat = np.asarray(tri["mat"], np.int64)
    for i, (_, tri_off, count) in enumerate(inst_spans):
        m = np.asarray(inst_m2w[i], np.float32)
        delta = inst_mat_deltas[i] if i < len(inst_mat_deltas) else 0
        if emissive_ids.size == 0:
            continue
        span = tri_mat[tri_off:tri_off + count] + delta
        # a mirrored transform (det < 0) flips the world-space winding
        # relative to the model-space backface cull: swap v1/v2 so the
        # kernel's -dot(cross(v1-v0, v2-v0), d) > 0 front test keeps
        # matching the side BSDF rays can actually hit
        mirrored = float(np.linalg.det(m[:3, :3].astype(np.float64))) < 0.0
        for t in (tri_off + np.nonzero(np.isin(span, emissive_ids))[0]):
            rec = records[int(tri_mat[t]) + delta]
            w = [tuple((m[:3, :3] @ v + m[:3, 3]).tolist())
                 for v in (tri["v0"][t], tri["v1"][t], tri["v2"][t])]
            if mirrored:
                w[1], w[2] = w[2], w[1]
            area = 0.5 * float(np.linalg.norm(
                np.cross(np.subtract(w[1], w[0]), np.subtract(w[2], w[0]))))
            if area <= 0.0:
                continue
            lights.append((0, *w[0], *w[1], *w[2], *radiance(rec), area))
    for centre, radius, mid in spheres:
        rec = records[mid]
        if not emissive(rec):
            continue
        area = float(4.0 * np.pi * radius * radius)
        lights.append((1, *(float(c) for c in np.asarray(centre)[:3]),
                       float(radius), 0.0, 0.0, 0.0, 0.0, 0.0,
                       *radiance(rec), area))
    if len(lights) > MAX_NEE_LIGHTS:
        log.warning(
            "scene has %d emissive primitives (> MAX_NEE_LIGHTS=%d): "
            "next-event estimation is DISABLED for it (a truncated table "
            "would lose energy)", len(lights), MAX_NEE_LIGHTS)
        return ()
    return tuple(lights)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class RenderScene:
    # Spheres (S may be 0)
    sphere_pos: jax.Array        # (S, 3) f32
    sphere_radius: jax.Array     # (S,) f32
    sphere_mat: jax.Array        # (S,) i32

    # Instance groups (I may be 0)
    inst_world_to_model: jax.Array  # (I, 4, 4) f32
    inst_model_to_world: jax.Array  # (I, 4, 4) f32
    inst_node_offset: jax.Array     # (I,) i32
    inst_tri_offset: jax.Array      # (I,) i32

    # Triangle soup, leaf-ordered, concatenated over groups, padded by
    # LEAF_CHUNK degenerate triangles at the end.
    tri_v0: jax.Array            # (T, 3) f32
    tri_v1: jax.Array
    tri_v2: jax.Array
    tri_n0: jax.Array
    tri_n1: jax.Array
    tri_n2: jax.Array
    tri_uv0: jax.Array           # (T, 2) f32
    tri_uv1: jax.Array
    tri_uv2: jax.Array
    tri_mat: jax.Array           # (T,) i32

    # BVH nodes, concatenated over groups (node indices are group-local;
    # traversal adds inst_node_offset, triangle ranges add inst_tri_offset —
    # same contract as ray_tracer.wgsl:292-335).
    node_min: jax.Array          # (N, 3) f32
    node_max: jax.Array
    node_left: jax.Array         # (N,) i32
    node_right: jax.Array
    node_first: jax.Array
    node_count: jax.Array

    # Octant skip-link threading (accel/threading.py): GLOBAL node indices,
    # -1 terminates; row = ray-direction octant.
    link_hit: jax.Array          # (8, N) i32
    link_miss: jax.Array         # (8, N) i32

    # Packed single-gather-per-step tables (accel/packed.py). The 8-octant
    # packed node rows that once lived here were dropped from the device
    # pytree: they served only the debug/tiled path, which now gathers the
    # unpacked node/link arrays directly (kernels/traverse.py
    # traverse_bvh).
    tri_attr: jax.Array          # (ceil(T/4), 128) f32 quad-packed attr rows
                                 # (normals, uvs, tangent frame — accel/packed.py)
    mat_rows: jax.Array          # (K, 32) f32 — packed material records
    tex_meta: jax.Array          # (64, 4) f32 — offset, h, w per texture slot

    # 16-ary CANONICAL wide rows (accel/wide.py): 3.6x fewer dependent
    # gathers than the binary skip-link tables, and a single table (not 8
    # octant copies) stays under the gather engine's ~8 MB fast region;
    # used by the megakernel's lit path.
    wide_rows: jax.Array         # (R, 128) f32

    materials: MaterialTable

    # Texture atlas (flat texel buffer + slot tables)
    tex_texels: jax.Array        # u8-RGBA atlas rows: QUAD layout
                                 # (ceil(X/32), 128) by default — one row
                                 # gather per bilinear sample
                                 # (pack_texels_u8_quads) — or PAIRED
                                 # (ceil(X/64), 128) rows (2 gathers) under
                                 # RT2_TEX_LAYOUT=pairs; see tex_quads below
    tex_offset: jax.Array        # (64,) i32
    tex_h: jax.Array             # (64,) i32
    tex_w: jax.Array             # (64,) i32

    # Camera uniform (camera.rs:15-22)
    cam_to_world: jax.Array      # (4, 4) f32
    view_params: jax.Array       # (3,) f32
    defocus_strength: jax.Array  # () f32
    diverge_strength: jax.Array  # () f32

    #: STATIC per-instance (node_offset, tri_offset, tri_count) — lets the
    #: kernel choose brute-force vs BVH per instance at trace time.
    inst_spans: tuple = dataclasses.field(metadata=dict(static=True),
                                          default=())
    #: STATIC per-instance wide-table root row id (aligned with inst_spans;
    #: -1 for brute-force groups) and the max wide-tree depth (stack bound).
    wide_roots: tuple = dataclasses.field(metadata=dict(static=True),
                                          default=())
    wide_depth: int = dataclasses.field(metadata=dict(static=True),
                                        default=4)
    #: STATIC per-instance material-id delta for instanced-geometry sharing:
    #: shared tables bake the canonical instance's ids; a sharing instance
    #: shades with id + delta (0 for canonical/unshared instances).
    inst_mat_deltas: tuple = dataclasses.field(metadata=dict(static=True),
                                               default=())
    #: STATIC sphere-BVH root row id in ``wide_rows`` (-1 ⇒ disengaged: the
    #: kernel tests every sphere densely per segment, like the reference's
    #: linear loop, ray_tracer.wgsl:357-364). Engaged for sphere counts
    #: where the dense cross dominates (SPHERE_BVH_MIN; RT2_SPHERE_BVH=0/1
    #: forces off/on).
    sphere_bvh_root: int = dataclasses.field(metadata=dict(static=True),
                                             default=-1)
    #: STATIC emissive-primitive table for next-event estimation
    #: (RenderParams.nee): tuple of rows
    #: (kind, x0,y0,z0, x1,y1,z1, x2,y2,z2, er,eg,eb, area) — kind 0 =
    #: world-space triangle (3 verts), kind 1 = sphere (row 1 = centre,
    #: row 2.x = radius, verts 1/2 otherwise unused). Hashable floats; the
    #: kernel folds them into compile-time constants. Empty ⇒ NEE disabled
    #: for the scene. Extracted from EVERY instance (brute and BVH) plus
    #: spheres — shadow-segment NEE covers traversal scenes too.
    lights: tuple = dataclasses.field(metadata=dict(static=True),
                                      default=())
    #: STATIC material-class summary ("glass"/"texture"/"normal_map" subset):
    #: lets the shading kernel compile OUT whole branches a scene never takes
    #: (the dragon has no glass → no refract/Schlick/Beer-Lambert code at
    #: all). RNG parity holds because the glass draw chain is independent of
    #: the non-glass chain (both fork from the same seed). Recomputed on
    #: material edits (a flag toggle recompiles, like any static change).
    shade_classes: tuple = dataclasses.field(metadata=dict(static=True),
                                             default=("glass", "texture",
                                                      "normal_map"))
    #: STATIC texel-table layout flag: True = quad rows (one gather per
    #: bilinear sample, pack_texels_u8_quads), False = paired rows (two
    #: gathers, pack_texels_u8_pairs). Kernel dispatch is compile-time.
    tex_quads: bool = dataclasses.field(metadata=dict(static=True),
                                        default=True)

    @property
    def n_spheres(self) -> int:
        return self.sphere_pos.shape[0]

    @property
    def n_instances(self) -> int:
        return self.inst_node_offset.shape[0]

    @property
    def n_triangles(self) -> int:
        return self.tri_v0.shape[0] - LEAF_CHUNK  # minus padding

    @property
    def n_nodes(self) -> int:
        return self.node_count.shape[0]

    @property
    def n_wide_rows(self) -> int:
        return self.wide_rows.shape[0]

    def with_camera(self, camera: Camera) -> "RenderScene":
        u = camera.to_uniform()
        return dataclasses.replace(
            self,
            cam_to_world=jnp.asarray(u.cam_to_world),
            view_params=jnp.asarray(u.view_params),
            defocus_strength=jnp.float32(u.defocus_strength),
            diverge_strength=jnp.float32(u.diverge_strength),
        )


@dataclasses.dataclass
class HostScene:
    """Host-side scene state: mutable camera + staging data + device pytree
    (ref ``Scene``, scene.rs:148-156).

    Live edits (the egui inspector's property editors, egui.rs:156-365)
    update only the affected device arrays — the reference re-uploads the
    whole scene every frame instead (ray_tracer.rs:397-419).
    """

    camera: Camera
    render_scene: RenderScene
    bvh_stats: list
    n_spheres: int
    n_instances: int
    n_triangles: int
    n_nodes: int
    #: per-entity material records (mutable; one row per entity)
    records: list = dataclasses.field(default_factory=list)
    #: per-instance-group host Transform (kept so partial UI edits preserve
    #: the untouched components — egui.rs:280-330 edits pos/rot/scale
    #: independently)
    inst_transforms: list = dataclasses.field(default_factory=list)
    #: per-instance-group material ids (one per submesh part)
    inst_material_ids: list = dataclasses.field(default_factory=list)
    #: per-group staging for cull-flag repacks: (bvh, v0, v1, v2, mats,
    #: node_offset, tri_offset) with leaf-ordered arrays
    _staging: list = dataclasses.field(default_factory=list)

    def refresh_camera(self) -> None:
        self.render_scene = self.render_scene.with_camera(self.camera)

    # ------------------------------------------------------- live edits

    def edit_sphere(self, index: int, centre=None, radius=None) -> None:
        """Move/resize a sphere (egui.rs:171-207). Scenes with an engaged
        sphere BVH rebuild its wide-row tail (cheap host work; the table
        shape may change, which recompiles — same cost class as any static
        scene change)."""
        rs = self.render_scene
        if centre is not None:
            rs = dataclasses.replace(rs, sphere_pos=rs.sphere_pos.at[index].set(
                jnp.asarray(centre, jnp.float32)))
        if radius is not None:
            rs = dataclasses.replace(
                rs, sphere_radius=rs.sphere_radius.at[index].set(float(radius)))
        self.render_scene = rs
        if rs.sphere_bvh_root >= 0:
            self._rebuild_sphere_rows()
        self._refresh_lights()

    def _rebuild_sphere_rows(self) -> None:
        """Re-derive the sphere-BVH tail of ``wide_rows`` from the current
        sphere arrays (kernels/megakernel.py traverses it in world space)."""
        from ray_tracer_2_tpu.accel.bvh import build_bvh_bounds
        from ray_tracer_2_tpu.accel.wide import SPH_CHUNK, \
            pack_sphere_wide_rows

        rs = self.render_scene
        root = rs.sphere_bvh_root
        sp = np.asarray(rs.sphere_pos)
        sr = np.asarray(rs.sphere_radius)
        sbvh = build_bvh_bounds(sp - sr[:, None], sp + sr[:, None], sp,
                                max_leaf=SPH_CHUNK)
        o = sbvh.tri_order
        rows, _n, d = pack_sphere_wide_rows(sbvh, sp[o], sr[o],
                                            row_offset=root)
        head = np.asarray(rs.wide_rows[:root])
        self.render_scene = dataclasses.replace(
            rs, wide_rows=jnp.asarray(np.concatenate([head, rows], axis=0)),
            wide_depth=max(rs.wide_depth, d))

    def edit_material(self, mat_id: int, **fields) -> None:
        """Edit one entity's material (egui.rs:209-365). Changing ``flag``
        (glass toggle) also refreshes the baked backface-cull flags in the
        packed traversal rows."""
        rec = self.records[mat_id]
        flag_before = rec.flag
        for k, v in fields.items():
            setattr(rec, k, tuple(v) if isinstance(v, (list, np.ndarray)) else v)
        rs = self.render_scene
        row = jnp.asarray(_pack_material_rows([rec])[0])
        rs = dataclasses.replace(rs, mat_rows=rs.mat_rows.at[mat_id].set(row))
        table = MaterialTable.from_records(self.records)
        rs = dataclasses.replace(rs, materials=table,
                                 shade_classes=_shade_classes(self.records))
        self.render_scene = rs
        if rec.flag != flag_before:
            self._repack_cull_flags()
        self._refresh_lights()

    def edit_instance_transform(self, index: int, transform=None, *,
                                pos=None, rot=None, scale=None) -> None:
        """Move/rotate/scale a whole instance group (egui.rs:280-330 mesh
        transform editor). Partial edits (only ``pos``/``rot``/``scale``)
        merge into the stored host transform, so editing one component
        preserves the others."""
        if transform is None:
            transform = self.inst_transforms[index].copy()
            if pos is not None:
                transform.pos = np.asarray(pos, np.float32)
            if rot is not None:
                transform.rot = np.asarray(rot, np.float32)
            if scale is not None:
                transform.scale = (np.asarray(scale, np.float32)
                                   * np.ones(3, np.float32))
        self.inst_transforms[index] = transform.copy()
        m = transform.to_matrix()
        inv = np.linalg.inv(m.astype(np.float64)).astype(np.float32)
        rs = self.render_scene
        rs = dataclasses.replace(
            rs,
            inst_model_to_world=rs.inst_model_to_world.at[index].set(
                jnp.asarray(m)),
            inst_world_to_model=rs.inst_world_to_model.at[index].set(
                jnp.asarray(inv)),
        )
        self.render_scene = rs
        self._refresh_lights()

    def _refresh_lights(self) -> None:
        """Re-derive the static NEE light table after a live edit that can
        move or re-color an emissive primitive (emission edits, sphere
        moves, instance transforms). A no-op when the table is unchanged
        (tuple equality), so non-light edits never trigger a recompile.
        (Editing an actual light with nee ON does recompile — the table is
        a static jit key; acceptable for inspector edits, same cost class
        as a glass-flag toggle.)"""
        rs = self.render_scene
        if not rs.lights and not any(
                r.emission_strength > 0.0 and max(r.emission_color[:3]) > 0.0
                for r in self.records):
            # nothing emissive before or after the edit: skip the device
            # readback entirely (the common case — e.g. every gizmo drag
            # tick on a light-free scene)
            return
        tri = {"v0": np.asarray(rs.tri_v0), "v1": np.asarray(rs.tri_v1),
               "v2": np.asarray(rs.tri_v2), "mat": np.asarray(rs.tri_mat)}
        m2w = list(np.asarray(rs.inst_model_to_world))
        spheres = [(p, float(r), int(m)) for p, r, m in
                   zip(np.asarray(rs.sphere_pos),
                       np.asarray(rs.sphere_radius),
                       np.asarray(rs.sphere_mat))]
        lights = _extract_lights(self.records, tri, rs.inst_spans, m2w,
                                 list(rs.inst_mat_deltas), spheres)
        if lights != rs.lights:
            self.render_scene = dataclasses.replace(rs, lights=lights)

    def _repack_cull_flags(self) -> None:
        from ray_tracer_2_tpu.accel.wide import pack_wide_rows

        mat_flags = np.array([r.flag for r in self.records] or [0], np.int32)
        wide_groups = []
        wide_cursor = 0
        for (bvh, v0, v1, v2, mats, node_off, tri_off,
             deltas) in self._staging:
            # shared-geometry groups: a triangle keeps its backface cull
            # only if NO sharing instance made its material glass —
            # conservative (less culling is always correct), and the flag
            # patterns matched at build time so this only weakens on a
            # post-build divergent glass toggle
            cull = np.ones(len(mats), np.float32)
            for d in deltas:
                cull *= (mat_flags[mats + d] != 1).astype(np.float32)
            wrows, wn, _ = pack_wide_rows(bvh, v0, v1, v2, mats, cull,
                                          row_offset=wide_cursor,
                                          tri_offset=tri_off)
            wide_groups.append(wrows)
            wide_cursor += wn
        if not wide_groups:
            return
        wide = np.concatenate(wide_groups, axis=0)
        rs = self.render_scene
        if rs.sphere_bvh_root >= 0:
            # sphere tail is cull-flag independent: carry it over verbatim
            assert wide_cursor == rs.sphere_bvh_root
            tail = np.asarray(rs.wide_rows[rs.sphere_bvh_root:])
            wide = np.concatenate([wide, tail], axis=0)
        self.render_scene = dataclasses.replace(
            rs, wide_rows=jnp.asarray(wide))


def instantiate_scene(definition: SceneDefinition,
                      assets=None,
                      quality: BVHQuality = BVHQuality.HIGH) -> HostScene:
    """Resolve entities → load assets → build BVHs → device arrays
    (ref: Scene::instantiate_scene, scene.rs:179-271)."""
    if assets is None:
        from ray_tracer_2_tpu.assets.manager import AssetManager
        assets = AssetManager()

    records: list[MaterialRecord] = []

    def mat_id(rec: MaterialRecord) -> int:
        # One row per entity/submesh — matches the reference's inline
        # per-primitive materials (sphere.rs:8, mesh.rs:55) so live edits
        # (egui.rs:156-365) affect exactly one entity.
        records.append(rec)
        return len(records) - 1

    spheres: list[tuple[np.ndarray, float, int]] = []
    # (transform_matrix_key) -> [(MeshData, mat_id)]
    raw_groups: dict[bytes, dict] = {}

    for e in definition.entities:
        diffuse_index = -1
        if e.material.diffuse_texture is not None:
            diffuse_index = assets.load_texture(e.material.diffuse_texture)
        normal_index = -1
        if e.material.normal_texture is not None:
            normal_index = assets.load_texture(e.material.normal_texture)
        resolved = e.material.resolve(diffuse_index=diffuse_index,
                                      normal_index=normal_index)

        prim = e.primitive
        if isinstance(prim, SphereDef):
            spheres.append((prim.centre, prim.radius, mat_id(resolved)))
            continue

        if isinstance(prim, MeshFromFile):
            submeshes = assets.load_model(prim.path, prim.use_mtl,
                                          override=resolved)
            parts = [(mesh, mat_id(rec)) for mesh, rec, _ in submeshes]
        else:  # MeshFromData
            parts = [(prim.resolved(), mat_id(resolved))]

        m = e.transform.to_matrix()
        key = m.tobytes()
        group = raw_groups.setdefault(key, {"matrix": m, "parts": [],
                                            "transform": e.transform})
        group["parts"].extend(parts)

    # ---- build per-group triangle soup + BVH ---------------------------
    from ray_tracer_2_tpu.accel.threading import compute_skip_links
    from ray_tracer_2_tpu.accel.wide import pack_wide_rows

    # Per-material backface-cull flag (cull unless GLASS — ray_tracer.wgsl:358,375)
    mat_flags = np.array([r.flag for r in records] or [0], np.int32)

    inst_w2m, inst_m2w, inst_node_off, inst_tri_off = [], [], [], []
    inst_counts, inst_transforms, inst_mat_ids = [], [], []
    tri_arrays = {k: [] for k in
                  ("v0", "v1", "v2", "n0", "n1", "n2", "uv0", "uv1", "uv2", "mat")}
    node_arrays = {k: [] for k in ("min", "max", "left", "right", "first",
                                   "count", "lhit", "lmiss")}
    wide_groups = []
    wide_root_list = []
    wide_cursor = 0
    wide_depth = 1
    staging = []
    bvh_stats = []
    tri_cursor = 0
    node_cursor = 0

    # Instanced-geometry sharing: groups whose parts reference the SAME
    # MeshData objects (the asset cache returns one object per model) with a
    # consistent material-id shift and identical glass-flag patterns share
    # one BVH + one set of traversal tables. The duplicate instance only
    # carries a material-id DELTA, so per-instance material edits stay
    # independent (the reference re-uploads duplicated mesh data instead;
    # room2's two dragons here share 5.9 MB of wide rows — which also keeps
    # the table under the gather engine's ~8 MB fast region).
    built_geo: dict[tuple, dict] = {}
    inst_mat_delta = []

    def _dedup_key(parts):
        return tuple(id(mesh) for mesh, _ in parts)

    def _try_share(group):
        canon = built_geo.get(_dedup_key(group["parts"]))
        if canon is None:
            return None
        a_ids = canon["mat_ids"]
        b_ids = [mid for _, mid in group["parts"]]
        deltas = {b - a for a, b in zip(a_ids, b_ids)}
        if len(deltas) != 1:
            return None
        if any(records[a].flag != records[b].flag
               for a, b in zip(a_ids, b_ids)):
            return None  # baked cull flags would diverge
        return canon, deltas.pop()

    for group in raw_groups.values():
        shared = _try_share(group)
        if shared is not None:
            canon, delta = shared
            inst_m2w.append(group["matrix"])
            inst_w2m.append(np.linalg.inv(
                group["matrix"].astype(np.float64)).astype(np.float32))
            inst_node_off.append(canon["node_off"])
            inst_tri_off.append(canon["tri_off"])
            inst_counts.append(canon["count"])
            inst_transforms.append(group["transform"].copy())
            inst_mat_ids.append(sorted({int(mid)
                                        for _, mid in group["parts"]}))
            inst_mat_delta.append(int(delta))
            wide_root_list.append(canon["wide_root"])
            canon["staging"][7].append(int(delta))  # sharing deltas
            continue

        soup = _concat_soup(group["parts"])
        if soup is None:
            continue
        v0, v1, v2, n0, n1, n2, uv0, uv1, uv2, mats = soup
        bvh = build_bvh(v0, v1, v2, quality=quality, max_leaf=LEAF_CHUNK)
        bvh_stats.append(bvh.stats)
        lhit, lmiss = compute_skip_links(bvh)
        node_arrays["lhit"].append(
            np.where(lhit >= 0, lhit + node_cursor, -1).astype(np.int32))
        node_arrays["lmiss"].append(
            np.where(lmiss >= 0, lmiss + node_cursor, -1).astype(np.int32))
        o = bvh.tri_order
        cull = (mat_flags[mats[o]] != 1).astype(np.float32)
        wrows, wn, wd = pack_wide_rows(bvh, v0[o], v1[o], v2[o], mats[o],
                                       cull, row_offset=wide_cursor,
                                       tri_offset=tri_cursor)
        wide_groups.append(wrows)
        wide_root_list.append(wide_cursor)
        wide_depth = max(wide_depth, wd)
        stage = (bvh, v0[o], v1[o], v2[o], mats[o],
                 node_cursor, tri_cursor, [0])
        staging.append(stage)
        built_geo[_dedup_key(group["parts"])] = dict(
            mat_ids=[mid for _, mid in group["parts"]],
            node_off=node_cursor, tri_off=tri_cursor, count=len(v0),
            wide_root=wide_cursor, staging=stage)
        wide_cursor += wn
        inst_mat_delta.append(0)
        tri_arrays["v0"].append(v0[o]); tri_arrays["v1"].append(v1[o])
        tri_arrays["v2"].append(v2[o])
        tri_arrays["n0"].append(n0[o]); tri_arrays["n1"].append(n1[o])
        tri_arrays["n2"].append(n2[o])
        tri_arrays["uv0"].append(uv0[o]); tri_arrays["uv1"].append(uv1[o])
        tri_arrays["uv2"].append(uv2[o])
        tri_arrays["mat"].append(mats[o])
        node_arrays["min"].append(bvh.node_min)
        node_arrays["max"].append(bvh.node_max)
        node_arrays["left"].append(bvh.node_left)
        node_arrays["right"].append(bvh.node_right)
        node_arrays["first"].append(bvh.node_first)
        node_arrays["count"].append(bvh.node_count)

        m = group["matrix"]
        inst_m2w.append(m)
        inst_w2m.append(np.linalg.inv(m.astype(np.float64)).astype(np.float32))
        inst_node_off.append(node_cursor)
        inst_tri_off.append(tri_cursor)
        inst_counts.append(len(v0))
        inst_transforms.append(group["transform"].copy())
        inst_mat_ids.append(sorted({int(mid) for _, mid in group["parts"]}))
        tri_cursor += len(v0)
        node_cursor += bvh.n_nodes

    n_tris = tri_cursor

    def cat(parts, pad_shape, dtype=np.float32):
        pad = np.zeros((LEAF_CHUNK, *pad_shape), dtype)
        arrs = parts + [pad]
        return np.concatenate(arrs, axis=0) if parts else pad

    tri = {
        k: cat(tri_arrays[k], (3,) if k.startswith(("v", "n")) and k != "mat"
               else ((2,) if k.startswith("uv") else ()),
               np.int32 if k == "mat" else np.float32)
        for k in tri_arrays
    }
    if node_cursor:
        nodes = {k: np.concatenate(node_arrays[k],
                                   axis=1 if k in ("lhit", "lmiss") else 0)
                 for k in node_arrays}
    else:
        nodes = {"min": np.zeros((0, 3), np.float32), "max": np.zeros((0, 3), np.float32),
                 "left": np.zeros(0, np.int32), "right": np.zeros(0, np.int32),
                 "first": np.zeros(0, np.int32), "count": np.zeros(0, np.int32),
                 "lhit": np.zeros((8, 0), np.int32),
                 "lmiss": np.zeros((8, 0), np.int32)}

    # ---- spheres --------------------------------------------------------
    if spheres:
        sphere_pos = np.stack([s[0] for s in spheres]).astype(np.float32)
        sphere_radius = np.array([s[1] for s in spheres], np.float32)
        sphere_mat = np.array([s[2] for s in spheres], np.int32)
    else:
        sphere_pos = np.zeros((0, 3), np.float32)
        sphere_radius = np.zeros(0, np.float32)
        sphere_mat = np.zeros(0, np.int32)

    # ---- sphere BVH (world space) — appended to the same wide table so
    # the traversal loop's row gather stays one table ---------------------
    sphere_bvh_root = -1
    if _sphere_bvh_engaged(len(spheres)):
        from ray_tracer_2_tpu.accel.bvh import build_bvh_bounds
        from ray_tracer_2_tpu.accel.wide import SPH_CHUNK, \
            pack_sphere_wide_rows
        sp = sphere_pos
        sr = sphere_radius
        sbvh = build_bvh_bounds(sp - sr[:, None], sp + sr[:, None], sp,
                                quality=quality, max_leaf=SPH_CHUNK)
        o = sbvh.tri_order
        srows, sn, sd = pack_sphere_wide_rows(sbvh, sp[o], sr[o],
                                              row_offset=wide_cursor)
        # leaf COL_SPH_ID must be the ORIGINAL id: pack gets leaf-ordered
        # pos/radius, and bvh.tri_order maps leaf slot -> original id
        wide_groups.append(srows)
        sphere_bvh_root = wide_cursor
        wide_cursor += sn
        wide_depth = max(wide_depth, sd)
        bvh_stats.append(sbvh.stats)

    from ray_tracer_2_tpu.accel.packed import pack_attr_quads, \
        pack_tri_attributes
    from ray_tracer_2_tpu.accel.wide import ROW_WIDTH as WIDE_ROW_WIDTH
    if wide_groups:
        wide = np.concatenate(wide_groups, axis=0)
    else:
        wide = np.zeros((0, WIDE_ROW_WIDTH), np.float32)
    tri_attr = pack_attr_quads(
        pack_tri_attributes(tri["n0"], tri["n1"], tri["n2"],
                            tri["uv0"], tri["uv1"], tri["uv2"],
                            tri["v0"], tri["v1"], tri["v2"]))

    tex_images = assets.texture_images()
    budget_mb = _tex_budget_mb()
    if budget_mb > 0:
        from ray_tracer_2_tpu.assets.textures import \
            downsample_images_to_budget
        # quad rows store 4 u8 words per texel = 16 B/texel
        bytes_per_texel = 16 if _tex_quads() else 8
        tex_images = downsample_images_to_budget(
            tex_images, budget_mb * (1 << 20) // bytes_per_texel)
    atlas = TextureAtlas.from_images(tex_images)
    table = MaterialTable.from_records(records)
    mat_rows = _pack_material_rows(records)
    tex_meta = np.stack([atlas.offsets, atlas.heights, atlas.widths,
                         np.zeros_like(atlas.offsets)], axis=1).astype(np.float32)
    cam_u = definition.camera.to_uniform()

    rs = RenderScene(
        sphere_pos=jnp.asarray(sphere_pos),
        sphere_radius=jnp.asarray(sphere_radius),
        sphere_mat=jnp.asarray(sphere_mat),
        inst_world_to_model=jnp.asarray(
            np.stack(inst_w2m) if inst_w2m else np.zeros((0, 4, 4), np.float32)),
        inst_model_to_world=jnp.asarray(
            np.stack(inst_m2w) if inst_m2w else np.zeros((0, 4, 4), np.float32)),
        inst_node_offset=jnp.asarray(np.array(inst_node_off, np.int32)),
        inst_tri_offset=jnp.asarray(np.array(inst_tri_off, np.int32)),
        inst_spans=tuple(
            (int(n), int(t), int(c))
            for n, t, c in zip(inst_node_off, inst_tri_off, inst_counts)),
        tri_v0=jnp.asarray(tri["v0"]), tri_v1=jnp.asarray(tri["v1"]),
        tri_v2=jnp.asarray(tri["v2"]),
        tri_n0=jnp.asarray(tri["n0"]), tri_n1=jnp.asarray(tri["n1"]),
        tri_n2=jnp.asarray(tri["n2"]),
        tri_uv0=jnp.asarray(tri["uv0"]), tri_uv1=jnp.asarray(tri["uv1"]),
        tri_uv2=jnp.asarray(tri["uv2"]),
        tri_mat=jnp.asarray(tri["mat"]),
        node_min=jnp.asarray(nodes["min"]), node_max=jnp.asarray(nodes["max"]),
        node_left=jnp.asarray(nodes["left"]), node_right=jnp.asarray(nodes["right"]),
        node_first=jnp.asarray(nodes["first"]), node_count=jnp.asarray(nodes["count"]),
        link_hit=jnp.asarray(nodes["lhit"]), link_miss=jnp.asarray(nodes["lmiss"]),
        wide_rows=jnp.asarray(wide),
        wide_roots=tuple(int(r) for r in wide_root_list),
        wide_depth=int(wide_depth),
        sphere_bvh_root=int(sphere_bvh_root),
        inst_mat_deltas=tuple(int(d) for d in inst_mat_delta),
        shade_classes=_shade_classes(records),
        lights=_extract_lights(
            records, tri,
            tuple((int(n), int(t), int(c))
                  for n, t, c in zip(inst_node_off, inst_tri_off,
                                     inst_counts)),
            inst_m2w, [int(d) for d in inst_mat_delta], spheres),
        tri_attr=jnp.asarray(tri_attr),
        mat_rows=jnp.asarray(mat_rows),
        tex_meta=jnp.asarray(tex_meta),
        materials=table,
        tex_texels=jnp.asarray((
            pack_texels_u8_quads if _tex_quads() else pack_texels_u8_pairs)(
            atlas.texels, atlas.offsets, atlas.heights, atlas.widths)),
        tex_quads=_tex_quads(),
        tex_offset=jnp.asarray(atlas.offsets),
        tex_h=jnp.asarray(atlas.heights),
        tex_w=jnp.asarray(atlas.widths),
        cam_to_world=jnp.asarray(cam_u.cam_to_world),
        view_params=jnp.asarray(cam_u.view_params),
        defocus_strength=jnp.float32(cam_u.defocus_strength),
        diverge_strength=jnp.float32(cam_u.diverge_strength),
    )
    log.info("scene instantiated: %d spheres, %d instance groups, %d tris, %d nodes",
             len(spheres), rs.n_instances, n_tris, rs.n_nodes)
    return HostScene(
        camera=definition.camera,
        render_scene=rs,
        bvh_stats=bvh_stats,
        n_spheres=len(spheres),
        n_instances=rs.n_instances,
        n_triangles=n_tris,
        n_nodes=rs.n_nodes,
        records=records,
        inst_transforms=inst_transforms,
        inst_material_ids=inst_mat_ids,
        _staging=staging,
    )


#: Packed material-row layout (see kernels/trace.py MatRow):
#: 0:4 color, 4:8 emission_color, 8:12 specular_color, 12:16 absorption,
#: 16 absorption_strength, 17 emission_strength, 18 smoothness, 19 specular,
#: 20 ior, 21 flag, 22 diffuse_index, 23 normal_index, 24:32 pad
def _pack_material_rows(records: list[MaterialRecord]) -> np.ndarray:
    if not records:
        records = [MaterialRecord()]
    rows = np.zeros((len(records), 32), np.float32)
    for i, r in enumerate(records):
        rows[i, 0:4] = r.color
        rows[i, 4:8] = r.emission_color
        rows[i, 8:12] = r.specular_color
        rows[i, 12:16] = r.absorption
        rows[i, 16] = r.absorption_strength
        rows[i, 17] = r.emission_strength
        rows[i, 18] = r.smoothness
        rows[i, 19] = r.specular
        rows[i, 20] = r.ior
        rows[i, 21] = float(r.flag)
        rows[i, 22] = float(r.diffuse_index)
        rows[i, 23] = float(r.normal_index)
    return rows


def _concat_soup(parts: list[tuple[MeshData, int]]):
    """Concatenate (MeshData, mat_id) parts into per-corner SoA arrays."""
    v0s, v1s, v2s, n0s, n1s, n2s, u0s, u1s, u2s, mats = ([] for _ in range(10))
    for mesh, mid in parts:
        idx = mesh.indices.reshape(-1, 3)
        if len(idx) == 0:
            continue
        p, n, uv = mesh.positions, mesh.normals, mesh.uvs
        v0s.append(p[idx[:, 0]]); v1s.append(p[idx[:, 1]]); v2s.append(p[idx[:, 2]])
        n0s.append(n[idx[:, 0]]); n1s.append(n[idx[:, 1]]); n2s.append(n[idx[:, 2]])
        u0s.append(uv[idx[:, 0]]); u1s.append(uv[idx[:, 1]]); u2s.append(uv[idx[:, 2]])
        mats.append(np.full(len(idx), mid, np.int32))
    if not v0s:
        return None
    c = lambda xs: np.concatenate(xs, axis=0)
    return (c(v0s), c(v1s), c(v2s), c(n0s), c(n1s), c(n2s),
            c(u0s), c(u1s), c(u2s), c(mats))

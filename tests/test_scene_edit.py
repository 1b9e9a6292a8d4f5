"""Live scene-edit semantics (egui.rs:156-365): edits hit exactly one entity
and re-upload only the affected arrays."""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest

from ray_tracer_2_tpu.config import RenderParams
from ray_tracer_2_tpu.engine.renderer import render_sample
from ray_tracer_2_tpu.scene import scenes
from ray_tracer_2_tpu.scene.render_scene import instantiate_scene


def render(rs, w=32, h=32):
    img, _ = render_sample(rs, jnp.int32(0), jnp.float32(1.0), width=w,
                           height=h, bounces=2, rays_per_pixel=1, skybox=True,
                           debug_mode=0, tile_rows=8)
    return np.asarray(img)


def test_sphere_move_changes_image():
    host = instantiate_scene(scenes.metal())
    before = render(host.render_scene)
    host.edit_sphere(1, centre=[0.0, 5.0, -1.0])  # move the red sphere away
    after = render(host.render_scene)
    assert not np.allclose(before, after)


def test_material_color_edit_is_per_entity():
    host = instantiate_scene(scenes.metal())
    rs = host.render_scene
    # every sphere owns a unique material row
    mats = np.asarray(rs.sphere_mat)
    assert len(set(mats.tolist())) == len(mats)
    mid = int(mats[1])
    host.edit_material(mid, color=(0.0, 0.0, 1.0, 1.0))
    row = np.asarray(host.render_scene.mat_rows[mid])
    np.testing.assert_allclose(row[0:4], [0, 0, 1, 1])
    # other rows untouched
    other = np.asarray(host.render_scene.mat_rows[int(mats[0])])
    assert not np.allclose(other[0:4], [0, 0, 1, 1])


def test_glass_toggle_repacks_cull_flags(assets):
    from tests.conftest import require_asset
    require_asset(assets, "CornellBox-Original.obj")
    host = instantiate_scene(scenes.cornell_box())
    rs = host.render_scene
    wide_before = np.asarray(rs.wide_rows)
    # toggle some mesh material to glass: cull flags for its triangles flip
    mid = int(np.asarray(rs.tri_mat)[0])
    host.edit_material(mid, flag=1, ior=1.5)
    wide_after = np.asarray(host.render_scene.wide_rows)
    assert not np.array_equal(wide_before, wide_after)
    # the wide leaf rows bake cull into the matcull low bit (accel/wide.py):
    # only those columns may differ
    from ray_tracer_2_tpu.accel.wide import COL_MATCULL
    from ray_tracer_2_tpu.scene.render_scene import LEAF_CHUNK
    diff_cols = np.unique(np.nonzero(wide_before != wide_after)[1])
    assert set(diff_cols.tolist()) <= set(
        range(COL_MATCULL, COL_MATCULL + LEAF_CHUNK))


def test_instance_transform_edit():
    from ray_tracer_2_tpu.math.transform import Transform
    host = instantiate_scene(scenes.room())
    before = render(host.render_scene)
    host.edit_instance_transform(0, Transform(pos=[0.0, 10.0, 0.0]))
    after = render(host.render_scene)
    assert not np.allclose(before, after)


def test_sponza_substitute_loads(assets):
    """The procedural sponza substitute completes the 7-scene list with the
    real sponza.mtl materials + textures."""
    from tests.conftest import require_asset
    require_asset(assets, "sponza.mtl")
    host = instantiate_scene(scenes.sponza())
    assert host.n_triangles > 20000
    assert len(host.records) >= 10
    # textured materials resolved to atlas slots
    import numpy as np
    assert (np.asarray(host.render_scene.materials.diffuse_index) >= 0).sum() >= 8


def test_partial_instance_edit_preserves_rotation_and_scale():
    """Viewer round-trip (egui.rs:280-330): moving an instance must not
    silently reset its rotation/scale."""
    from ray_tracer_2_tpu.math.transform import Transform, quat_rotate_y
    from ray_tracer_2_tpu.scene.camera import CameraDescriptor
    from ray_tracer_2_tpu.scene.definition import (MeshData, MeshFromData,
                                                   SceneDefinition)
    from ray_tracer_2_tpu.scene.material import MaterialDefinition

    s = SceneDefinition()
    s.set_camera(CameraDescriptor(
        transform=Transform.cam([0, 1, 4], [0, 0.5, 0]), fov=45.0,
        focus_dist=4.0))
    rot0 = quat_rotate_y(0.6)
    s.add_mesh(Transform(pos=[0, 0.5, 0], rot=rot0, scale=[2.0, 1.0, 1.0]),
               MeshFromData(MeshData.quad(), indices=[0, 1, 2, 0, 2, 3]),
               MaterialDefinition.new().with_color([0.9, 0.2, 0.2, 1.0]))
    host = instantiate_scene(s)

    before = render(host.render_scene)
    host.edit_instance_transform(0, pos=[0.3, 0.5, 0.0])
    after = render(host.render_scene)
    assert not np.allclose(before, after)

    t = host.inst_transforms[0]
    np.testing.assert_allclose(t.rot, rot0, atol=1e-6)
    np.testing.assert_allclose(t.scale, [2.0, 1.0, 1.0], atol=1e-6)
    np.testing.assert_allclose(t.pos, [0.3, 0.5, 0.0], atol=1e-6)
    # matrix rebuilt from the merged transform, not from pos alone
    expect = Transform(pos=[0.3, 0.5, 0.0], rot=rot0,
                       scale=[2.0, 1.0, 1.0]).to_matrix()
    np.testing.assert_allclose(
        np.asarray(host.render_scene.inst_model_to_world[0]), expect,
        atol=1e-6)

    # rotation-only edit keeps the new position
    host.edit_instance_transform(0, rot=quat_rotate_y(1.2))
    t = host.inst_transforms[0]
    np.testing.assert_allclose(t.pos, [0.3, 0.5, 0.0], atol=1e-6)


def test_instance_material_edit_via_server_path():
    """Mesh material editing (egui.rs:209-278) through the instance's
    material-id list."""
    host = instantiate_scene(scenes.room())
    assert host.inst_material_ids and host.inst_material_ids[0]
    before = render(host.render_scene)
    for mid in host.inst_material_ids[0]:
        host.edit_material(mid, color=[0.05, 0.9, 0.05, 1.0])
    after = render(host.render_scene)
    assert not np.allclose(before, after)

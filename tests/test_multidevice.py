"""Multi-chip equivalence on 8 virtual CPU devices (SURVEY.md §4): pixel-tile
sharding must be bit-identical to single-device rendering — per-pixel
counter RNG means zero cross-tile coupling."""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from ray_tracer_2_tpu.config import RenderParams
from ray_tracer_2_tpu.engine.renderer import render_frame
from ray_tracer_2_tpu.parallel.sharding import (
    make_render_mesh, make_render_mesh2d, render_frame_hybrid_sharded,
    render_frame_sharded, render_frame_spp_sharded, replicate_scene,
    shard_framebuffer,
)
from ray_tracer_2_tpu.scene import scenes
from ray_tracer_2_tpu.scene.render_scene import instantiate_scene


@pytest.fixture(scope="module")
def scene():
    return instantiate_scene(scenes.metal()).render_scene


def test_eight_virtual_devices():
    assert len(jax.devices()) == 8, "conftest must provide 8 fake CPU devices"


def test_row_sharded_matches_single_device(scene):
    W, H = 32, 32
    mesh = make_render_mesh()
    fb0 = jnp.zeros((H, W, 4), jnp.float32)

    single, _segs = render_frame(scene, fb0, jnp.int32(2), jnp.float32(1.0),
                                 width=W, height=H, bounces=2, rays_per_pixel=1,
                                 skybox=True, debug_mode=0, tile_rows=4)

    fb_sharded = shard_framebuffer(jnp.zeros((H, W, 4), jnp.float32), mesh)
    scene_rep = replicate_scene(scene, mesh)
    sharded, segs = render_frame_sharded(scene_rep, fb_sharded, 2, 1.0,
                                         mesh=mesh, width=W, height=H,
                                         bounces=2, rays_per_pixel=1,
                                         skybox=True, tile_rows=4)
    # Same math, different XLA executables: agreement to float reassociation
    # noise (the RNG streams and hit logic are identical per pixel).
    np.testing.assert_allclose(np.asarray(single), np.asarray(sharded),
                               atol=1e-6, rtol=1e-6)
    # exact segment counting survives sharding (one psum per frame)
    assert float(segs) == float(_segs)


def test_spp_sharded_converges(scene):
    W, H = 16, 16
    mesh = make_render_mesh()
    fb = jnp.zeros((H, W, 4), jnp.float32)
    scene_rep = replicate_scene(scene, mesh)
    out, _ = render_frame_spp_sharded(scene_rep, fb, 0, mesh=mesh, width=W,
                                      height=H, bounces=2, rays_per_pixel=1,
                                      skybox=True, tile_rows=4)
    out = np.asarray(out)
    assert np.isfinite(out).all() and out[..., :3].max() > 0
    # 8-way spp mean should be visibly smoother than a single sample
    single_fb, _ = render_frame(scene, fb, jnp.int32(-1), jnp.float32(1.0),
                                width=W, height=H, bounces=2,
                                rays_per_pixel=1, skybox=True,
                                debug_mode=0, tile_rows=4)
    single = np.asarray(single_fb)
    def tv(img):
        return np.abs(np.diff(img[..., :3], axis=0)).mean()
    assert tv(out) < tv(single)


def test_row_sharded_wide_bvh_matches_single_device():
    """The HEADLINE code path — 32-ary wide-BVH traversal in the persistent
    megakernel (resume stacks, traced row_start seeding, completion-log
    reassembly) — under shard_map: row-sharded must equal single-device on
    a >1024-tri instance (the brute path compiles traversal out below that,
    kernels/megakernel.py _bvh_instances)."""
    from tests.test_oracle_mesh import bvh_mesh_scene
    rs = bvh_mesh_scene.__wrapped__()
    assert any(c > 1024 for _, _, c in rs.inst_spans), \
        "fixture must exercise the wide-BVH path"

    W, H = 32, 32
    mesh = make_render_mesh()
    fb0 = jnp.zeros((H, W, 4), jnp.float32)
    single, _segs = render_frame(rs, fb0, jnp.int32(1), jnp.float32(1.0),
                                 width=W, height=H, bounces=2,
                                 rays_per_pixel=1, skybox=True, debug_mode=0,
                                 tile_rows=4)
    fb_sharded = shard_framebuffer(jnp.zeros((H, W, 4), jnp.float32), mesh)
    sharded, segs = render_frame_sharded(replicate_scene(rs, mesh),
                                         fb_sharded, 1, 1.0, mesh=mesh,
                                         width=W, height=H, bounces=2,
                                         rays_per_pixel=1, skybox=True,
                                         tile_rows=4)
    np.testing.assert_allclose(np.asarray(single), np.asarray(sharded),
                               atol=1e-6, rtol=1e-6)
    assert float(segs) == float(_segs)


def test_row_sharded_sphere_bvh_matches_single_device(monkeypatch):
    """Sphere-BVH phase (accel/wide.py pack_sphere_wide_rows) under
    shard_map: forced engagement on the metal scene's spheres... requires
    > 8 spheres, so uses random_balls at small size."""
    monkeypatch.setenv("RT2_SPHERE_BVH", "1")
    rs = instantiate_scene(scenes.random_balls()).render_scene
    assert rs.sphere_bvh_root >= 0

    W, H = 32, 16
    mesh = make_render_mesh()
    fb0 = jnp.zeros((H, W, 4), jnp.float32)
    single, _segs = render_frame(rs, fb0, jnp.int32(1), jnp.float32(1.0),
                                 width=W, height=H, bounces=2,
                                 rays_per_pixel=1, skybox=True, debug_mode=0,
                                 tile_rows=4)
    fb_sharded = shard_framebuffer(jnp.zeros((H, W, 4), jnp.float32), mesh)
    sharded, segs = render_frame_sharded(replicate_scene(rs, mesh),
                                         fb_sharded, 1, 1.0, mesh=mesh,
                                         width=W, height=H, bounces=2,
                                         rays_per_pixel=1, skybox=True,
                                         tile_rows=4)
    np.testing.assert_allclose(np.asarray(single), np.asarray(sharded),
                               atol=1e-6, rtol=1e-6)
    assert float(segs) == float(_segs)


@pytest.mark.parametrize("shape", [(2, 4), (4, 2)])
def test_hybrid_mesh_matches_composed_single_device(scene, shape):
    """Hybrid rows x spp sharding over a 2-D mesh must equal the composed
    single-device computation: the S per-chip samples of accumulation
    round k are the ordinary full-frame renders at RNG frames k*S+j, so
    mean(those) blended at 1/(k+1) is the exact expectation. Segment
    counting must survive the two-axis psum exactly."""
    from ray_tracer_2_tpu.engine.renderer import render_sample
    W, H = 16, 16
    R, S = shape
    mesh = make_render_mesh2d(R, S)
    frames = 2   # mid-accumulation round, non-trivial blend weight

    samples, seg_sum = [], 0.0
    for j in range(S):
        smp, segs = render_sample(
            scene, jnp.int32(frames * S + j), jnp.float32(1.0), width=W,
            height=H, bounces=2, rays_per_pixel=1, skybox=True,
            debug_mode=0, tile_rows=4)
        samples.append(np.asarray(smp))
        seg_sum += float(segs)
    w = 1.0 / (frames + 1)
    expected = np.mean(samples, axis=0) * w   # prior framebuffer is zero

    fb = shard_framebuffer(jnp.zeros((H, W, 4), jnp.float32), mesh)
    out, segs = render_frame_hybrid_sharded(
        replicate_scene(scene, mesh), fb, frames, mesh=mesh, width=W,
        height=H, bounces=2, rays_per_pixel=1, skybox=True, tile_rows=4)
    np.testing.assert_allclose(np.asarray(out), expected,
                               atol=1e-6, rtol=1e-6)
    assert float(segs) == seg_sum


def test_uneven_mesh_subset(scene):
    """Sharding over a 4-device sub-mesh also works."""
    W, H = 16, 16
    mesh = make_render_mesh(4)
    fb = shard_framebuffer(jnp.zeros((H, W, 4), jnp.float32), mesh)
    out, _ = render_frame_sharded(replicate_scene(scene, mesh), fb, -1, 1.0,
                                  mesh=mesh, width=W, height=H, bounces=1,
                                  rays_per_pixel=1, skybox=True, tile_rows=4)
    assert np.isfinite(np.asarray(out)).all()


def test_renderer_auto_mesh_bitequal_with_flags(scene):
    """The Renderer auto-adopts a rows mesh on
    a multi-device host and its output — with NEE + antialias ON and
    explicit tuning knobs — is bit-equal to the forced single-device
    Renderer. This is the render path the Engine/viewer loop uses, not a
    bench side path."""
    import dataclasses as dc

    from ray_tracer_2_tpu.engine.renderer import Renderer

    W, H = 32, 32
    p = RenderParams(width=W, height=H, bounces=2, rays_per_pixel=1,
                     skybox=True, frames=1)
    p = dc.replace(p, nee=True, antialias=True)

    kw = dict(lanes=256, unroll=3, log_cap=128)
    auto = Renderer(**kw)                 # mesh="auto" default
    single = Renderer(mesh=None, **kw)

    fb_a = np.asarray(auto.render(scene, p))
    fb_s = np.asarray(single.render(scene, p))
    assert auto.mesh is not None, "auto mesh must engage on 8 fake devices"
    np.testing.assert_allclose(fb_a, fb_s, atol=1e-6, rtol=1e-6)
    assert float(auto.last_segments) == float(single.last_segments)


def test_renderer_auto_mesh_debug_mode(scene):
    """Debug modes run row-sharded too (deterministic tiled path with a
    traced per-chip row offset)."""
    from ray_tracer_2_tpu.config import DebugMode
    from ray_tracer_2_tpu.engine.renderer import Renderer

    W, H = 32, 32
    p = RenderParams(width=W, height=H, bounces=1, rays_per_pixel=1,
                     skybox=True, frames=0, debug_mode=DebugMode.NORMALS)
    auto = Renderer(tile_rows=4, tile_cols=16)
    single = Renderer(tile_rows=4, tile_cols=16, mesh=None)
    fb_a = np.asarray(auto.render(scene, p))
    fb_s = np.asarray(single.render(scene, p))
    np.testing.assert_allclose(fb_a, fb_s, atol=1e-5, rtol=1e-5)

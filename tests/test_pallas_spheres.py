"""Whole-path small-scene kernel (kernels/pallas_spheres.py) vs the XLA
paths, in the Pallas interpreter on CPU.

The kernel reimplements the full path trace component-wise for the GPU;
the RNG stream and op order match kernels/trace.py, so agreement must be
near-bitwise, including exact traced-segment counts on sphere scenes. The
compiled kernel is checked against the XLA megakernel on the card by
chip_smoke.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ray_tracer_2_tpu.config import RenderParams
from ray_tracer_2_tpu.engine.renderer import Renderer, render_sample
from ray_tracer_2_tpu.kernels import pallas_spheres
from ray_tracer_2_tpu.kernels.pallas_spheres import (eligible,
                                                     render_spheres_pallas)
from ray_tracer_2_tpu.scene import scenes
from ray_tracer_2_tpu.scene.render_scene import instantiate_scene


def _both(rs, W, H, bounces, rpp, frames=2):
    img_p, segs_p = render_spheres_pallas(
        rs, jnp.int32(frames), width=W, height=H, bounces=bounces,
        rays_per_pixel=rpp, skybox=True, interpret=True)
    img_x, segs_x = render_sample(
        rs, jnp.int32(frames), jnp.float32(1.0), width=W, height=H,
        bounces=bounces, rays_per_pixel=rpp, skybox=True, debug_mode=0,
        tile_rows=8)
    err = np.abs(np.asarray(img_p) - np.asarray(img_x)).max(axis=-1)
    return float(segs_p), float(segs_x), err


@pytest.mark.parametrize("build,name", [(scenes.metal, "metal"),
                                        (scenes.balls, "balls")])
def test_matches_xla_paths(build, name):
    rs = instantiate_scene(build()).render_scene
    assert eligible(rs)
    segs_p, segs_x, err = _both(rs, 64, 36, bounces=3, rpp=2)
    assert segs_p == segs_x
    frac = (err < 1e-3).mean()
    assert frac >= 0.99, f"{name}: {frac:.2%} pixels match (max {err.max()})"


def test_small_image_matches():
    """16x8 (one partial block of 128 rays) at rpp 1: the non-slow case."""
    rs = instantiate_scene(scenes.metal()).render_scene
    segs_p, segs_x, err = _both(rs, 16, 8, bounces=2, rpp=1)
    assert segs_p == segs_x
    assert (err < 1e-3).mean() >= 0.99


def test_glass_scene_matches():
    """random_balls includes glass + specular + ~484 spheres (31 chunks)."""
    rs = instantiate_scene(scenes.random_balls()).render_scene
    assert eligible(rs)
    segs_p, segs_x, err = _both(rs, 48, 27, bounces=2, rpp=1, frames=1)
    # float re-association can flip a rare RNG/threshold decision on one
    # lane (observed: 2246 vs 2245 segments); demand near-exact agreement
    assert abs(segs_p - segs_x) <= 2
    assert (err < 1e-3).mean() >= 0.98


def test_eligibility_gates():
    room = instantiate_scene(scenes.room()).render_scene
    assert eligible(room)      # small mesh (12 tris): handled in-kernel
    # texture_test with its earth map generated in memory (no file asset)
    from ray_tracer_2_tpu.assets.manager import AssetManager
    am = AssetManager()
    am.loaded_textures["earthmap.png"] = 0
    am.cpu_textures[0] = np.random.default_rng(0).integers(
        0, 256, (8, 16, 4)).astype(np.float32) / 255.0
    tex = instantiate_scene(scenes.texture_test(), assets=am).render_scene
    assert not eligible(tex)   # texture sampling not implemented in-kernel


@pytest.mark.parametrize("build,name", [(scenes.cornell_box, "cornell"),
                                        (scenes.room, "room")])
def test_triangle_scenes_match_xla(build, name, assets):
    """Small-mesh scenes run whole-path with WORLD-baked triangles. The
    XLA path intersects in model space and re-measures world distance, so
    agreement is FP-noise-level (same RNG stream, same draws) rather than
    bit-exact: gate on pixel-match fraction, not segment counts."""
    if name == "cornell":
        from tests.conftest import require_asset
        require_asset(assets, "CornellBox-Original.obj")
    rs = instantiate_scene(build()).render_scene
    assert eligible(rs)
    segs_p, segs_x, err = _both(rs, 64, 36, bounces=3, rpp=1)
    # a boundary FP flip re-routes a whole path; allow a small tail
    rel = abs(segs_p - segs_x) / segs_x
    assert rel < 0.02, f"{name}: segment counts diverge {rel:.3%}"
    frac = (err < 1e-3).mean()
    assert frac >= 0.95, f"{name}: {frac:.2%} pixels match (max {err.max()})"


@pytest.mark.parametrize("width,height", [(16, 8), (13, 7), (130, 1)])
def test_padding_and_shapes(width, height):
    """Totals that are not a multiple of the block: the padded tail rays
    trace nothing (segment count == the unpadded image's), and the output
    has the image's shape."""
    rs = instantiate_scene(scenes.metal()).render_scene
    img, segs = render_spheres_pallas(
        rs, jnp.int32(0), width=width, height=height, bounces=0,
        rays_per_pixel=1, skybox=True, interpret=True)
    assert img.shape == (height, width, 4)
    assert float(segs) == width * height      # bounces=0: one segment each
    assert np.isfinite(np.asarray(img)).all()
    n_blocks = -(-width * height // pallas_spheres.BLOCK)
    assert n_blocks * pallas_spheres.BLOCK >= width * height


@pytest.mark.parametrize("backend,expect", [("gpu", True), ("cpu", False)])
def test_routing_only_on_gpu(monkeypatch, backend, expect):
    """The kernel is chosen on backend "gpu" only, and the render path
    never asks for the interpreter there."""
    rs = instantiate_scene(scenes.metal()).render_scene
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    monkeypatch.delenv("RT2_PALLAS_SPHERES", raising=False)
    r = Renderer(mesh=None)
    p = RenderParams(width=16, height=8, bounces=1, rays_per_pixel=1)
    _, kwargs = r.frame_call(rs, p)
    assert kwargs["pallas_spheres"] is expect

    seen = {}

    def fake(scene, frames, **kw):
        seen.update(kw)
        return jnp.zeros((8, 16, 4)), jnp.float32(0)

    monkeypatch.setattr(pallas_spheres, "render_spheres_pallas", fake)
    render_sample(rs, jnp.int32(0), jnp.float32(1.0), width=16, height=8,
                  bounces=1, rays_per_pixel=1, skybox=True, debug_mode=0,
                  tile_rows=8, pallas_spheres=True)
    assert not seen.get("interpret", False)


def test_routing_respects_flags_and_override(monkeypatch):
    rs = instantiate_scene(scenes.metal()).render_scene
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    p = RenderParams(width=16, height=8, bounces=1, rays_per_pixel=1)
    monkeypatch.setenv("RT2_PALLAS_SPHERES", "0")
    assert not Renderer(mesh=None)._use_pallas_spheres(rs, p)
    monkeypatch.delenv("RT2_PALLAS_SPHERES")
    p_nee = RenderParams(width=16, height=8, bounces=1, rays_per_pixel=1,
                         nee=True)
    assert not Renderer(mesh=None)._use_pallas_spheres(rs, p_nee)


@pytest.mark.chip
def test_compiled_kernel_matches_xla(card):
    """The kernel as compiled for the card (no interpreter) against the
    XLA megakernel on the card, on the glass + mesh scene."""
    rs = instantiate_scene(scenes.room()).render_scene
    img_p, segs_p = render_spheres_pallas(
        rs, jnp.int32(1), width=128, height=72, bounces=3,
        rays_per_pixel=1, skybox=True)
    img_x, segs_x = render_sample(
        rs, jnp.int32(1), jnp.float32(1.0), width=128, height=72,
        bounces=3, rays_per_pixel=1, skybox=True, debug_mode=0, tile_rows=8)
    assert abs(float(segs_p) - float(segs_x)) <= 0.01 * float(segs_x)
    err = np.abs(np.asarray(img_p) - np.asarray(img_x)).max(axis=-1)
    assert (err < 1e-3).mean() >= 0.98

"""Persistent-lanes renderer must match the tiled/layered renderer exactly:
same pixel seeds, same sample continuation, same physics."""
import numpy as np
import jax.numpy as jnp
import pytest

from ray_tracer_2_tpu.kernels.megakernel import render_persistent
from ray_tracer_2_tpu.kernels.trace import trace_pixels
from ray_tracer_2_tpu.scene import scenes
from ray_tracer_2_tpu.scene.render_scene import instantiate_scene

from tests.conftest import require_asset


@pytest.fixture(scope="module")
def dragon_scene(assets):
    require_asset(assets, "dragon.obj")
    return instantiate_scene(scenes.obj_test()).render_scene


@pytest.mark.parametrize("rpp", [1, 2])
def test_persistent_matches_tiled(dragon_scene, rpp):
    rs = dragon_scene
    W, H = 32, 18
    img_p, segs_p = render_persistent(rs, jnp.int32(3), width=W, height=H,
                                      bounces=3, rays_per_pixel=rpp,
                                      skybox=True, lanes=256)
    xs, ys = np.meshgrid(np.arange(W), np.arange(H))
    color, seg = trace_pixels(rs, jnp.asarray(xs.ravel(), jnp.int32),
                              jnp.asarray(ys.ravel(), jnp.int32),
                              jnp.int32(3), width=W, height=H, bounces=3,
                              rays_per_pixel=rpp, skybox=True)
    ref = np.asarray(color).reshape(H, W, 4)
    got = np.asarray(img_p)
    err = np.abs(got - ref).max(axis=-1)
    frac = (err < 1e-4).mean()
    assert frac >= 0.99, f"{frac:.2%} pixels match, max err {err.max()}"
    assert abs(float(segs_p) - float(np.asarray(seg).sum())) \
        <= 0.01 * float(segs_p) + 5


def test_persistent_row_block(dragon_scene):
    """row_start/rows slicing (multi-chip row blocks) matches the full image."""
    rs = dragon_scene
    W, H = 24, 16
    full, _ = render_persistent(rs, jnp.int32(1), width=W, height=H,
                                bounces=2, rays_per_pixel=1, skybox=True,
                                lanes=128)
    top, _ = render_persistent(rs, jnp.int32(1), width=W, height=H,
                               bounces=2, rays_per_pixel=1, skybox=True,
                               row_start=0, rows=H // 2, lanes=128)
    bot, _ = render_persistent(rs, jnp.int32(1), width=W, height=H,
                               bounces=2, rays_per_pixel=1, skybox=True,
                               row_start=H // 2, rows=H // 2, lanes=128)
    np.testing.assert_allclose(np.asarray(full),
                               np.concatenate([top, bot], axis=0), atol=1e-5)


@pytest.mark.parametrize("kw", [dict(boundaries=2),
                                dict(boundaries=3, log_cap=64),
                                dict(log_cap=32)])
def test_boundary_chain_and_log_cap_bitexact(dragon_scene, kw):
    """Chained boundary phases and the capped/deferred completion log must
    be BIT-identical to the default single-boundary, uncapped path: pixel
    values derive from pixel ids, deferral replays the boundary resolve
    from unchanged lane state, and every pixel still logs exactly once."""
    rs = dragon_scene
    W, H = 32, 18
    base, segs0 = render_persistent(rs, jnp.int32(2), width=W, height=H,
                                    bounces=3, rays_per_pixel=1,
                                    skybox=True, lanes=256)
    got, segs1 = render_persistent(rs, jnp.int32(2), width=W, height=H,
                                   bounces=3, rays_per_pixel=1,
                                   skybox=True, lanes=256, **kw)
    assert (np.asarray(base) == np.asarray(got)).all()
    assert float(segs0) == float(segs1)


def test_striped_claim_matches_queue(dragon_scene):
    """claim="striped" must produce the identical image: per-pixel values
    derive from pixel ids, so the assignment scheme is invisible
    (the knob is kept for measurement, so gate it)."""
    rs = dragon_scene
    W, H = 32, 18
    q, segs_q = render_persistent(rs, jnp.int32(1), width=W, height=H,
                                  bounces=3, rays_per_pixel=1, skybox=True,
                                  lanes=256, claim="queue")
    s, segs_s = render_persistent(rs, jnp.int32(1), width=W, height=H,
                                  bounces=3, rays_per_pixel=1, skybox=True,
                                  lanes=256, claim="striped")
    assert (np.asarray(q) == np.asarray(s)).all()
    assert float(segs_q) == float(segs_s)


@pytest.mark.parametrize("cohorts", [2, 4])
def test_cohorts_bitexact(dragon_scene, cohorts):
    """The lane-cohort interleaving knob (bench --cohorts; measured and
    rejected as default before the H100 port) splits the lane batch into
    independently-stepping cohorts sharing one pixel cursor and completion
    log. Pixel values derive only from pixel ids, so any cohort count must
    reproduce the single-batch image bit-for-bit."""
    rs = dragon_scene
    W, H = 32, 18
    base, segs0 = render_persistent(rs, jnp.int32(2), width=W, height=H,
                                    bounces=3, rays_per_pixel=1,
                                    skybox=True, lanes=256)
    got, segs1 = render_persistent(rs, jnp.int32(2), width=W, height=H,
                                   bounces=3, rays_per_pixel=1,
                                   skybox=True, lanes=256, cohorts=cohorts)
    assert (np.asarray(base) == np.asarray(got)).all()
    assert float(segs0) == float(segs1)

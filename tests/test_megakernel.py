"""The flat megakernel must reproduce the layered bounce loop exactly: same
RNG streams, same physics, same hits — on a scene exercising every phase
(spheres + brute-force quad + a BVH dragon instance)."""
import numpy as np
import jax.numpy as jnp
import pytest

from ray_tracer_2_tpu import rng
from ray_tracer_2_tpu.kernels.megakernel import _bvh_instances, trace_batch_flat
from ray_tracer_2_tpu.kernels.trace import camera_ray_basis, trace_batch
from ray_tracer_2_tpu.math.vec import normalize
from ray_tracer_2_tpu.scene import scenes
from ray_tracer_2_tpu.scene.render_scene import instantiate_scene

from tests.conftest import require_asset


@pytest.fixture(scope="module")
def dragon_scene(assets):
    require_asset(assets, "dragon.obj")
    return instantiate_scene(scenes.obj_test()).render_scene


def test_scene_has_all_phases(dragon_scene):
    assert dragon_scene.n_spheres == 3
    assert len(_bvh_instances(dragon_scene)) == 1
    assert len(dragon_scene.inst_spans) == 1  # dragon+quad share the identity transform?


def test_flat_matches_layered(dragon_scene):
    rs = dragon_scene
    W, H = 48, 27
    xs, ys = np.meshgrid(np.arange(0, W, 3), np.arange(0, H, 3))
    xs = jnp.asarray(xs.ravel(), jnp.int32)
    ys = jnp.asarray(ys.ravel(), jnp.int32)
    cam_o, cam_r, cam_u, fp = camera_ray_basis(rs, xs, ys, W, H)
    B = xs.shape[0]
    origin = jnp.broadcast_to(cam_o, (B, 3))
    direction = normalize(fp - origin)
    seed = rng.seed_for_pixel((ys * W + xs).astype(jnp.uint32), jnp.int32(2))

    la, sa, ga = trace_batch(rs, origin, direction, seed, bounces=4,
                             skybox=True)
    lb, sb, gb = trace_batch_flat(rs, origin, direction, seed, bounces=4,
                                  skybox=True)
    la, lb = np.asarray(la), np.asarray(lb)
    err = np.abs(la - lb).max(axis=1)
    frac = (err < 1e-4).mean()
    assert frac >= 0.98, f"{frac:.2%} match, max err {err.max()}"
    # identical RNG consumption for matching rays
    same = err < 1e-4
    np.testing.assert_array_equal(np.asarray(sa)[same], np.asarray(sb)[same])
    np.testing.assert_array_equal(np.asarray(ga)[same], np.asarray(gb)[same])


def test_log_pixel_encoding_is_denormal_free():
    """The completion log carries pixel ids bitcast into an f32 payload
    column; a backend that flushes DENORMAL f32s to zero inside fused
    copies would scramble whole renders (the reassembly key is the id).
    The encoding must only ever produce normal-float bit patterns, and must
    round-trip every representable pixel id."""
    import numpy as np

    from ray_tracer_2_tpu.kernels.megakernel import (decode_log_ids,
                                                     encode_log_ids)

    ids = np.concatenate([
        np.arange(0, 4096, dtype=np.int32),               # the denormal zone
        np.asarray([8_294_399, 2**23 - 1], np.int32),     # 4K and the cap
        np.random.default_rng(0).integers(0, 2**23, 65536).astype(np.int32),
    ])
    encoded = np.asarray(encode_log_ids(jnp.asarray(ids)))
    exponents = (encoded.view(np.uint32) >> 23) & 0xFF
    assert (exponents != 0).all(), "denormal payload pattern"
    assert (exponents != 0xFF).all(), "inf/nan payload pattern"
    decoded = np.asarray(decode_log_ids(jnp.asarray(encoded)))
    assert (decoded == ids).all()

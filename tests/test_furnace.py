"""Analytic furnace test — an oracle-independent ground truth.

The Cornell fidelity chain bottoms out at
``tests/oracle.py``, an independent implementation but same-author; a
genuinely third-party path tracer would retire the residual circularity,
but none exists in this zero-egress image (no pbrt/mitsuba; torch/PIL only).
The replacement is MATHEMATICS: a closed furnace has a closed-form
radiance no implementation can bias.

Scene: the camera sits inside one huge sphere whose material both emits E
per hit and reflects with albedo a. Every path segment hits the sphere,
collects ``E * trans`` and multiplies ``trans`` by ``a``; with the bounce
budget b the exact expected radiance is the truncated geometric series

    L = E * (1 + a + a^2 + ... + a^b) = E * (1 - a^(b+1)) / (1 - a)

independent of geometry, RNG, and sampling direction (the uniform-
hemisphere pdf cancels exactly for constant incident radiance — this is
the standard white-furnace identity). Russian roulette truncates paths
stochastically but is unbiased by construction (ray_tracer.wgsl:462-466),
so the pixel MEAN must converge to L. Every pixel has the same
expectation, so averaging over pixels AND frames gives a tight gate
without long runs."""
import dataclasses

import numpy as np
import jax.numpy as jnp

from ray_tracer_2_tpu.config import RenderParams
from ray_tracer_2_tpu.engine.renderer import Renderer
from ray_tracer_2_tpu.scene.camera import CameraDescriptor
from ray_tracer_2_tpu.scene.definition import SceneDefinition
from ray_tracer_2_tpu.scene.material import MaterialDefinition
from ray_tracer_2_tpu.math.transform import Transform
from ray_tracer_2_tpu.scene.render_scene import instantiate_scene


def _furnace_scene(albedo: float, emission: float) -> SceneDefinition:
    """Closed CUBE furnace (12 inward triangles), camera at the centre.

    A sphere enclosure leaks by construction: a bounce origin lands
    outside the sphere by f32 ulps about 15% of the time, the quadratic's
    ``dst_near == 0`` inside test then reads the next hit as front-face,
    the hemisphere flips outward and the path exits (measured q ~ 0.85
    effective per-bounce survival at albedo 1 — reference-faithful
    behavior, ray_tracer.wgsl:240-244 has the identical test and no
    diffuse origin offset). Planar walls are immune: the same-plane
    re-hit distance is ~0 < EPSILON (ray_tracer.wgsl:131), so the closed
    form holds exactly."""
    from ray_tracer_2_tpu.scene.scenes import _quad_mesh

    s = SceneDefinition()
    s.set_camera(CameraDescriptor(
        transform=Transform.cam([0.0, 0.0, 0.0], [0.0, 0.0, -1.0]),
        fov=60.0, focus_dist=1.0))
    mat = (MaterialDefinition.new()
           .with_color([albedo] * 3 + [1.0])
           # specular=0: MaterialDefinition.new() defaults specular=0.1
           # and a specular bounce multiplies by specular_color instead
           # of the albedo, which would break the closed form (the same
           # gotcha the NEE cone-sampler CI gate hit, PLAN round-3)
           .specular_([1.0] * 4, 0.0)
           .emissive([emission] * 3 + [0.0], 1.0))
    h = 5.0
    t = Transform()
    # six inward-facing quads (winding chosen so inward normals are front)
    walls = [
        ([[-h, -h, -h], [h, -h, -h], [h, h, -h], [-h, h, -h]],
         [0, 0, 1], [0, 1, 2, 0, 2, 3]),                     # back (z=-h)
        ([[-h, -h, h], [h, -h, h], [h, h, h], [-h, h, h]],
         [0, 0, -1], [2, 1, 0, 3, 2, 0]),                    # front (z=+h)
        ([[-h, -h, -h], [-h, -h, h], [-h, h, h], [-h, h, -h]],
         [1, 0, 0], [2, 1, 0, 3, 2, 0]),                     # left (x=-h)
        ([[h, -h, -h], [h, -h, h], [h, h, h], [h, h, -h]],
         [-1, 0, 0], [0, 1, 2, 0, 2, 3]),                    # right (x=+h)
        ([[-h, -h, -h], [h, -h, -h], [h, -h, h], [-h, -h, h]],
         [0, 1, 0], [2, 1, 0, 3, 2, 0]),                     # floor (y=-h)
        ([[-h, h, -h], [h, h, -h], [h, h, h], [-h, h, h]],
         [0, -1, 0], [0, 1, 2, 0, 2, 3]),                    # ceiling (y=+h)
    ]
    for verts, n, idx in walls:
        s.add_mesh(t, _quad_mesh(verts, n, idx), mat)
    return s


def test_furnace_matches_closed_form():
    albedo, emission, bounces = 0.5, 0.3, 6
    host = instantiate_scene(_furnace_scene(albedo, emission))
    p = RenderParams(width=64, height=32, bounces=bounces, rays_per_pixel=1,
                     skybox=False, frames=0)
    r = Renderer(lanes=256, mesh=None)
    n = 24
    for f in range(n):
        fb = r.render(host.render_scene, dataclasses.replace(p, frames=f))
    img = np.asarray(fb)    # progressive mean over n frames
    expected = emission * (1.0 - albedo ** (bounces + 1)) / (1.0 - albedo)
    measured = float(img[..., :3].mean())
    assert abs(measured - expected) / expected < 0.02, \
        (measured, expected)

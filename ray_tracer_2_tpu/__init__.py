"""ray_tracer_2_tpu — a progressive path-tracing framework in JAX.

A ground-up rebuild of the capabilities of ``addiswebb/ray_tracer_2`` (a Rust +
WGSL real-time GPU path tracer): scenes are pure functional SoA pytrees, the
render step is a single ``jit``-compiled JAX/Pallas program, multi-device
scaling uses ``jax.sharding`` pixel-tile sharding, and the host runtime
(assets, BVH build, viewer) runs in Python/C++ off the device path. It runs
on an NVIDIA GPU; the package name is historical.

Layer map (mirrors SURVEY.md §1 of the reference):
  kernels/   device compute: intersection, traversal, shading (ref: shaders/ray_tracer.wgsl)
  accel/     BVH build (ref: src/core/bvh.rs)
  scene/     scene & camera schema, 7 built-in scenes (ref: src/scene/)
  assets/    OBJ/MTL/PNG loading (ref: src/core/asset.rs)
  engine/    render loop, params, accumulation, export (ref: src/core/{engine,app}.rs)
  parallel/  device-mesh sharding (ref: n/a — reference is single-GPU)
  viewer/    interactive viewer (ref: src/rendering/egui.rs)
  debug/     debug render modes 1-7 (ref: shaders/ray_tracer.wgsl:502-573)
"""

__version__ = "0.1.0"

from ray_tracer_2_tpu.config import RenderParams  # noqa: F401

"""raytracinggpu — a Monte-Carlo path-tracing framework in JAX for the GPU.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of the CUDA
reference renderer souhhcong/RaytracingGPU (SURVEY.md):

- structure-of-arrays math core (``core``) instead of per-ray Vector classes
  (reference: global_launcher.cu:40-99),
- batched, typed intersection ops (``ops``) instead of virtual dispatch inside
  kernels (reference: global_launcher.cu:101-113, 716-736),
- a host BVH builder emitting flat SoA node arrays (``accel``; reference:
  optimized.cu:476-534),
- a wavefront integrator with exact backward-composite semantics
  (``integrator``; reference: global_launcher.cu:738-839),
- single-frame + progressive/realtime render pipelines (``render``; reference:
  optimized.cu:774-884, realtime_render.cu:1244-1298),
- multi-device pixel/sample sharding over a jax device mesh (``parallel``)
  — the scale-out the single-GPU reference lacks,
- benchmark harness (``bench``; reference: benchmark.py:1-38) and CLI (``cli``).
"""

__version__ = "0.1.0"

from raytracinggpu.api import Renderer  # noqa: F401
from raytracinggpu.core.vec import Vec3  # noqa: F401

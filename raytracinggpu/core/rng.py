"""Counter-based PRNG and the reference's sampling formulas.

The reference uses per-thread cuRAND states seeded by thread id
(global_launcher.cu:887-888) or WangHash(frame)+threadId for frame
decorrelation in the realtime renderer (realtime_render.cu:1105-1106,
1188-1195) — nondeterministic across runs on CPU (thread_local mt19937 seeded
``clock()+seed``, cpu_launcher.cpp:530-536).

The replacement here is JAX's threefry counter PRNG keyed by
``(frame, depth, purpose)`` with array draws over the ray batch: reproducible
by construction (same seed ⇒ bit-identical frame) and embarrassingly parallel.

The *sampling formulas* are kept identical to the reference so images match
within Monte-Carlo tolerance:

- Box–Muller anti-aliasing jitter, sigma=0.2 (global_launcher.cu:905-912),
- cosine-weighted hemisphere sampling via tangent frame
  (global_launcher.cu:808-826).

For exact (non-statistical) differential testing every consumer accepts
pre-drawn uniforms, so a NumPy oracle can be fed the same numbers.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from raytracinggpu.core.vec import Vec3


def frame_key(seed: int | jax.Array, frame=0) -> jax.Array:
    """Root key for one frame; frame folding replaces WangHash(framenumber)
    (realtime_render.cu:1188-1195)."""
    key = seed if isinstance(seed, jax.Array) and jnp.issubdtype(seed.dtype, jnp.dtype("uint32")) else jax.random.PRNGKey(seed)
    return jax.random.fold_in(key, frame)


def uniform_open0(key: jax.Array, shape) -> jax.Array:
    """Uniforms in (0, 1] matching curand_uniform's support, so log(r1) in
    Box–Muller is finite (curand_uniform excludes 0.0, includes 1.0)."""
    return 1.0 - jax.random.uniform(key, shape, dtype=jnp.float32)


def box_muller_jitter(r1, r2, sigma):
    """Anti-aliasing pixel jitter (global_launcher.cu:909-911):
    (sigma*sqrt(-2 ln r1) cos(2 pi r2), sigma*sqrt(-2 ln r1) sin(2 pi r2))."""
    mag = sigma * jnp.sqrt(-2.0 * jnp.log(r1))
    return mag * jnp.cos(2.0 * jnp.pi * r2), mag * jnp.sin(2.0 * jnp.pi * r2)


def tangent_frame(N: Vec3) -> tuple[Vec3, Vec3]:
    """Reference tangent construction (global_launcher.cu:815-822):
    T1 = (-N.y, N.x, 0) when |N.y| != 0 and |N.x| != 0, else (-N.z, 0, N.x);
    T2 = N x T1."""
    cond = (jnp.abs(N.y) != 0.0) & (jnp.abs(N.x) != 0.0)
    t1 = Vec3(
        jnp.where(cond, -N.y, -N.z),
        jnp.where(cond, N.x, jnp.zeros_like(N.x)),
        jnp.where(cond, jnp.zeros_like(N.x), N.x),
    )
    t1 = t1.normalized()
    t2 = N.cross(t1)
    return t1, t2


def cosine_hemisphere(r1, r2, N: Vec3) -> Vec3:
    """Cosine-weighted hemisphere sample around N
    (global_launcher.cu:810-823):
    x = cos(2 pi r1) sqrt(1-r2), y = sin(2 pi r1) sqrt(1-r2), z = sqrt(r2)."""
    x = jnp.cos(2.0 * jnp.pi * r1) * jnp.sqrt(1.0 - r2)
    y = jnp.sin(2.0 * jnp.pi * r1) * jnp.sqrt(1.0 - r2)
    z = jnp.sqrt(r2)
    t1, t2 = tangent_frame(N)
    return t1 * x + t2 * y + N * z

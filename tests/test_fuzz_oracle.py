"""Randomized differential fuzzing vs the NumPy oracle: random sphere scenes
with every material class (diffuse / mirror / refractive incl. nested media)
and random meshes, exact injected uniforms."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytracinggpu.integrator.wavefront import trace
from raytracinggpu.oracle.numpy_ref import OracleScene
from raytracinggpu.scene.presets import make_config, wall_spheres
from raytracinggpu.scene.scene import build_scene_tables
from tests.test_integrator import _camera_rays, _vec


@pytest.mark.parametrize("seed", [7, 42, 1001])
def test_random_sphere_scene_matches_oracle(seed):
    rng = np.random.default_rng(seed)
    spheres, mats = wall_spheres(990.0)
    # 3 random inner spheres with random material classes.
    for _ in range(3):
        c = tuple(rng.uniform(-20, 20, 2)) + (float(rng.uniform(0, 30)),)
        r = float(rng.uniform(2, 8))
        kind = rng.integers(0, 3)
        if kind == 0:
            m = (tuple(rng.uniform(0, 1, 3)), False, 1.0, 1.0)
        elif kind == 1:
            m = ((0.0, 0.0, 0.0), True, 1.0, 1.0)
        else:
            m = ((0.0, 0.0, 0.0), False, float(rng.uniform(1.2, 1.8)), 1.0)
        spheres.append((c, r))
        mats.append(m)

    cfg = make_config(
        "global", mesh_object_id=-1, n_objects=len(spheres),
        width=16, height=16, spp=1, max_depth=4,
    )
    tables = build_scene_tables(spheres, mats, L=(-10, 20, 40), intensity=3e10, mesh=None)
    oracle = OracleScene(spheres, mats, L=(-10, 20, 40), intensity=3e10)

    O, u = _camera_rays(16, 16)
    R = 16 * 16
    uniforms = rng.random((4, 2, R)).astype(np.float32) * 0.998 + 1e-3
    col, _ = jax.jit(trace, static_argnums=1)(
        tables, cfg, _vec(O), _vec(u), jnp.asarray(uniforms)
    )
    ref = oracle.trace(O, u, uniforms, 4, cfg.eps_bounce, cfg.eps_leaf)
    got = np.stack([np.asarray(c) for c in col], -1)
    bad = np.abs(got - ref) > 3e-3 * np.abs(ref) + 3.0
    assert bad.any(-1).mean() < 0.04, f"{bad.any(-1).mean():.2%} disagree"


@pytest.mark.parametrize("seed", [3, 99])
def test_random_mesh_matches_oracle(seed):
    """Random triangle soup + walls, walk kernel (interpret) vs the
    oracle's naive intersection."""
    rng = np.random.default_rng(seed)
    T = 200
    A = rng.uniform(-15, 15, (T, 3)).astype(np.float32)
    B = A + rng.standard_normal((T, 3)).astype(np.float32) * 3
    C = A + rng.standard_normal((T, 3)).astype(np.float32) * 3

    import raytracinggpu.scene.mesh as meshmod
    from raytracinggpu.accel.bvh import build_bvh

    bvh = build_bvh(A, B, C)
    o = bvh.order
    z = np.zeros_like(A)
    mesh = meshmod.MeshData(
        A=A[o].copy(), B=B[o].copy(), C=C[o].copy(),
        na=z, nb=z, nc=z, bvh=bvh, n_vertices=3 * T, n_normals=0,
    )
    spheres, mats = wall_spheres(990.0)
    tables = build_scene_tables(
        spheres, mats, L=(-10, 20, 40), intensity=3e10, mesh=mesh,
    )
    oracle = OracleScene(
        spheres, mats, L=(-10, 20, 40), intensity=3e10,
        tris=(A, B, C), mesh_mat=((0.25, 0.25, 0.25), False, 1.0, 1.0),
    )
    cfg = make_config("array_bvh", width=12, height=12, spp=1, max_depth=2,
                      traversal="walk")
    O, u = _camera_rays(12, 12)
    R = 144
    uniforms = rng.random((2, 2, R)).astype(np.float32) * 0.998 + 1e-3
    col, _ = jax.jit(trace, static_argnums=1)(
        tables, cfg, _vec(O), _vec(u), jnp.asarray(uniforms)
    )
    ref = oracle.trace(O, u, uniforms, 2, cfg.eps_bounce, cfg.eps_leaf)
    got = np.stack([np.asarray(c) for c in col], -1)
    bad = np.abs(got - ref) > 3e-3 * np.abs(ref) + 3.0
    assert bad.any(-1).mean() < 0.05

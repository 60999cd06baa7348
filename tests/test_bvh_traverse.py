"""Stackless skip-link BVH traversal vs the dense matmul path."""
import numpy as np
import jax.numpy as jnp

from raytracinggpu.core.vec import Vec3
from raytracinggpu.ops.bvh_traverse import intersect_tris_bvh
from raytracinggpu.ops.sphere import INF
from raytracinggpu.ops.triangle import build_tri_tables, intersect_tris_dense


def test_bvh_traversal_matches_dense_cat(cat_mesh_raw, rng):
    from raytracinggpu.scene.mesh import build_mesh
    from raytracinggpu.scene.scene import build_scene_tables
    from raytracinggpu.scene.presets import wall_spheres

    mesh = build_mesh(cat_mesh_raw)
    spheres, mats = wall_spheres(990.0)
    tables = build_scene_tables(spheres, mats, L=(-10, 20, 40), intensity=3e10, mesh=mesh)

    n = 512
    o = rng.uniform(-30, 30, (n, 3)).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    O = Vec3(*(jnp.asarray(o[:, i]) for i in range(3)))
    u = Vec3(*(jnp.asarray(d[:, i]) for i in range(3)))

    bh = intersect_tris_bvh(O, u, tables.mesh, tables.bvh, eps_leaf=1e-4)
    dh = intersect_tris_dense(O, u, tables.mesh, eps_leaf=1e-4)

    t_b, t_d = np.asarray(bh.t), np.asarray(dh.t)
    hit_b, hit_d = t_b < INF, t_d < INF
    np.testing.assert_array_equal(hit_b, hit_d)
    np.testing.assert_allclose(t_b[hit_b], t_d[hit_d], rtol=1e-5, atol=1e-5)
    agree = (np.asarray(bh.idx)[hit_b] == np.asarray(dh.idx)[hit_b]).mean()
    assert agree > 0.995  # exact ties at shared edges may differ

    # node-layout ablation: the AoS 10-float record walk must be
    # BIT-identical to the SoA column walk (same arithmetic, different
    # gather strategy — SURVEY §2.11)
    ah = intersect_tris_bvh(O, u, tables.mesh, tables.bvh, eps_leaf=1e-4,
                            node_layout="aos10")
    np.testing.assert_array_equal(np.asarray(ah.t), t_b)
    np.testing.assert_array_equal(np.asarray(ah.idx), np.asarray(bh.idx))
    np.testing.assert_array_equal(np.asarray(ah.beta), np.asarray(bh.beta))


def test_bvh_mode_full_trace(cat_mesh_raw, rng):
    import dataclasses
    import jax

    from raytracinggpu.integrator.wavefront import trace
    from raytracinggpu.scene.mesh import build_mesh
    from raytracinggpu.scene.presets import build_preset
    from tests.test_integrator import _camera_rays, _vec

    mesh = build_mesh(cat_mesh_raw)
    cfg, tables = build_preset("array_bvh", mesh=mesh, spp=1, max_depth=2, traversal="dense")
    W = H = 12
    cfg = dataclasses.replace(cfg, width=W, height=H)
    O, u = _camera_rays(W, H)
    uniforms = jnp.asarray(rng.random((2, 2, W * H)).astype(np.float32) * 0.998 + 1e-3)
    col_d, _ = jax.jit(trace, static_argnums=1)(
        tables, dataclasses.replace(cfg, traversal="dense"), _vec(O), _vec(u), uniforms
    )
    col_b, _ = jax.jit(trace, static_argnums=1)(
        tables, dataclasses.replace(cfg, traversal="bvh"), _vec(O), _vec(u), uniforms
    )
    a = np.stack([np.asarray(c) for c in col_d], -1)
    b = np.stack([np.asarray(c) for c in col_b], -1)
    bad = np.abs(a - b) > 1e-3 * np.abs(a) + 1.0
    assert bad.any(-1).mean() < 0.02

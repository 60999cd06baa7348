"""Differential tests: the JAX wavefront integrator vs the independent NumPy
oracle, with *identical injected uniforms* so images must match to float
tolerance (much stronger than Monte-Carlo tolerance).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytracinggpu.core.vec import Vec3
from raytracinggpu.integrator.wavefront import intersect_all, trace
from raytracinggpu.oracle.numpy_ref import OracleScene
from raytracinggpu.scene.presets import make_config, wall_spheres
from raytracinggpu.scene.scene import build_scene_tables


def _spheres_scene():
    spheres, mats = wall_spheres(990.0)
    cfg = make_config("global", mesh_object_id=-1, n_objects=6, spp=2, max_depth=3)
    tables = build_scene_tables(spheres, mats, L=(-10, 20, 40), intensity=3e10, mesh=None)
    oracle = OracleScene(spheres, mats, L=(-10, 20, 40), intensity=3e10)
    return cfg, tables, oracle


def _camera_rays(W, H, fov=np.pi / 3, C=(0, 0, 55)):
    x = np.arange(W, dtype=np.float32)
    y = np.arange(H, dtype=np.float32)
    ux = np.tile(x - W / 2 + 0.5, H)
    uy = np.repeat(H / 2 - y - 0.5, W)
    z = np.float32(-W / (2 * np.tan(fov / 2)))
    d = np.stack([ux, uy, np.full(W * H, z, np.float32)], -1)
    u = d / np.linalg.norm(d, axis=-1, keepdims=True)
    O = np.tile(np.asarray(C, np.float32), (W * H, 1))
    return O.astype(np.float32), u.astype(np.float32)


def _vec(a):
    return Vec3(jnp.asarray(a[:, 0]), jnp.asarray(a[:, 1]), jnp.asarray(a[:, 2]))


def test_intersect_all_spheres_matches_oracle():
    cfg, tables, oracle = _spheres_scene()
    O, u = _camera_rays(16, 16)
    h = intersect_all(tables, cfg, _vec(O), _vec(u))
    t0, obj0, N0, P0 = oracle.intersect_all(O, u, cfg.eps_leaf)
    np.testing.assert_array_equal(np.asarray(h.obj), obj0)
    hit = obj0 >= 0
    np.testing.assert_allclose(np.asarray(h.t)[hit], t0[hit], rtol=1e-4)
    N = np.stack([np.asarray(h.N.x), np.asarray(h.N.y), np.asarray(h.N.z)], -1)
    np.testing.assert_allclose(N[hit], N0[hit], atol=1e-4)


@pytest.mark.parametrize("depth", [1, 3])
def test_trace_spheres_matches_oracle(depth, rng):
    import dataclasses

    cfg, tables, oracle = _spheres_scene()
    cfg = dataclasses.replace(cfg, max_depth=depth)
    W = H = 16
    O, u = _camera_rays(W, H)
    R = W * H
    uniforms = rng.random((depth, 2, R)).astype(np.float32) * 0.998 + 1e-3
    col, stats = jax.jit(trace, static_argnums=1)(
        tables, cfg, _vec(O), _vec(u), jnp.asarray(uniforms),
    )
    ref = oracle.trace(O, u, uniforms, depth, cfg.eps_bounce, cfg.eps_leaf)
    got = np.stack([np.asarray(col.x), np.asarray(col.y), np.asarray(col.z)], -1)
    # Radiance magnitudes are ~1e5-1e6; compare relatively.  A handful of
    # lanes may land on shadow/branch decision boundaries where float
    # summation order flips the outcome — bound the fraction, require the
    # rest to match tightly.
    bad = np.abs(got - ref) > 2e-3 * np.abs(ref) + 2.0
    frac_bad = bad.any(-1).mean()
    assert frac_bad < 0.02, f"{frac_bad:.3%} rays disagree with oracle"
    # Every camera ray hits the enclosed scene.
    assert int(np.asarray(stats.hit)[0]) == R


def test_trace_with_cat_mesh_matches_oracle(rng, cat_mesh_raw):
    """Full scene (walls + cat mesh): the oracle uses the *original* OBJ
    triangle order with naive intersection, so this also validates the BVH
    reorder + dense matmul path end to end."""
    from raytracinggpu.scene.mesh import build_mesh, rescale
    from raytracinggpu.scene.presets import build_preset
    import dataclasses

    obj = cat_mesh_raw
    verts = rescale(obj.vertices * 0.8 + np.array([0, -10, 0], np.float32), 0.6, (0, -4, 0))
    obj2 = dataclasses.replace(obj, vertices=verts)
    mesh = build_mesh(obj2)
    cfg, tables = build_preset("global", mesh=mesh, spp=1, max_depth=2, traversal="dense")

    A = verts[obj.vtx[:, 0]]
    B = verts[obj.vtx[:, 1]]
    C = verts[obj.vtx[:, 2]]
    spheres, mats = wall_spheres(990.0)
    oracle = OracleScene(
        spheres, mats, L=(-10, 20, 40), intensity=3e10,
        tris=(A, B, C), mesh_mat=((0.25, 0.25, 0.25), False, 1.0, 1.0),
    )

    W = H = 24
    cfg = dataclasses.replace(cfg, width=W, height=H)
    O, u = _camera_rays(W, H)
    R = W * H
    depth = 2
    uniforms = rng.random((depth, 2, R)).astype(np.float32) * 0.998 + 1e-3
    col, stats = jax.jit(trace, static_argnums=1)(
        tables, cfg, _vec(O), _vec(u), jnp.asarray(uniforms)
    )
    ref = oracle.trace(O, u, uniforms, depth, cfg.eps_bounce, cfg.eps_leaf)
    got = np.stack([np.asarray(col.x), np.asarray(col.y), np.asarray(col.z)], -1)
    bad = np.abs(got - ref) / (np.abs(ref) + 1.0) > 5e-3
    frac_bad = bad.any(-1).mean()
    # A tiny fraction of rays may flip at triangle-edge decision boundaries
    # (different float summation order in the matmul formulation).
    assert frac_bad < 0.02, f"{frac_bad:.3%} rays disagree with oracle"


def test_depth_unroll_bitwise_equivalent():
    """depth_unroll (RenderConfig) is a pure scheduling knob: the unrolled
    lax.scan must produce bit-identical frames.  The default is 8; the
    test conftest pins RT_DEPTH_UNROLL=1 for compile speed, so this is the
    one place the unrolled path is exercised on CPU."""
    import dataclasses

    from raytracinggpu.render.pipeline import render_preset_frame
    from raytracinggpu.scene.presets import build_preset

    cfg, tables = build_preset(
        "array_bvh", width=48, height=48, spp=2, max_depth=3,
        traversal="dense")
    imgs = []
    for unroll in (1, 3, 8):
        c = dataclasses.replace(cfg, depth_unroll=unroll)
        img, _ = render_preset_frame(tables, c, seed=0)
        imgs.append(np.asarray(img))
    np.testing.assert_array_equal(imgs[0], imgs[1])
    np.testing.assert_array_equal(imgs[0], imgs[2])

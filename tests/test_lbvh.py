"""Morton LBVH builder: invariants, layout compatibility, hit parity."""
import numpy as np
import jax.numpy as jnp

from raytracinggpu.accel.bvh import check_invariants
from raytracinggpu.accel.lbvh import build_lbvh, morton_codes
from raytracinggpu.core.vec import Vec3
from raytracinggpu.ops.sphere import INF
from raytracinggpu.ops.walk import intersect_tris_walk


def test_morton_ordering_groups_nearby_points():
    pts = np.array([[0, 0, 0], [0.01, 0, 0], [1, 1, 1], [0.99, 1, 1]], np.float32)
    c = morton_codes(pts)
    order = np.argsort(c, kind="stable")
    # Nearby points are adjacent in Morton order.
    pos = np.empty(4, int)
    pos[order] = np.arange(4)
    assert abs(pos[0] - pos[1]) == 1
    assert abs(pos[2] - pos[3]) == 1


def test_lbvh_invariants_random(rng):
    A = (rng.random((300, 3)) * 10).astype(np.float32)
    B = A + rng.standard_normal((300, 3)).astype(np.float32)
    C = A + rng.standard_normal((300, 3)).astype(np.float32)
    bvh = build_lbvh(A, B, C)
    check_invariants(bvh, A, B, C)


def test_lbvh_invariants_cat(cat_mesh_raw):
    obj = cat_mesh_raw
    A = obj.vertices[obj.vtx[:, 0]]
    B = obj.vertices[obj.vtx[:, 1]]
    C = obj.vertices[obj.vtx[:, 2]]
    bvh = build_lbvh(A, B, C)
    check_invariants(bvh, A, B, C)
    leaves = bvh.right == -1
    sizes = (bvh.tri_end - bvh.tri_start)[leaves]
    # Morton splits always bisect, so no degenerate giant leaves.
    assert sizes.max() <= 8


def test_lbvh_hit_parity_with_reference_builder(cat_mesh_raw, rng):
    """Same mesh, both builders, walk kernel: identical hit results."""
    from raytracinggpu.scene.mesh import build_mesh
    from raytracinggpu.scene.presets import build_preset

    tabs = [
        build_preset("array_bvh", mesh=build_mesh(cat_mesh_raw, builder=b),
                     width=8, height=8)[1].walk
        for b in ("reference", "lbvh")
    ]

    n = 256
    o = rng.uniform(-25, 25, (n, 3)).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    O = Vec3(*(jnp.asarray(o[:, i]) for i in range(3)))
    u = Vec3(*(jnp.asarray(d[:, i]) for i in range(3)))

    h_ref, h_lb = (intersect_tris_walk(O, u, tab, 1e-4) for tab in tabs)
    t_r, t_l = np.asarray(h_ref.t), np.asarray(h_lb.t)
    np.testing.assert_array_equal(t_r < INF, t_l < INF)
    hit = t_r < INF
    np.testing.assert_allclose(t_r[hit], t_l[hit], rtol=1e-5, atol=1e-5)

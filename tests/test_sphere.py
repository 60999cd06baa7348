"""Analytic ray-sphere cases (reference semantics: Sphere::intersect,
global_launcher.cu:122-135)."""
import jax.numpy as jnp
import numpy as np

from raytracinggpu.core.vec import Vec3
from raytracinggpu.ops.sphere import INF, SphereTable, intersect_spheres


def _rays(origins, dirs):
    o = np.asarray(origins, np.float32)
    d = np.asarray(dirs, np.float32)
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    return Vec3(*[jnp.asarray(o[:, i]) for i in range(3)]), Vec3(
        *[jnp.asarray(d[:, i]) for i in range(3)]
    )


def test_unit_sphere_analytic():
    tab = SphereTable.from_list([((0.0, 0.0, 0.0), 1.0)])
    O, u = _rays(
        [
            (0, 0, 5),    # head-on: t = 4
            (0, 0, 0),    # inside: t1 = -1 < 0 -> t2 = 1
            (0, 2, 5),    # clean miss
            (0, 0, -5),   # behind when pointing away: t2 < 0 -> miss
            (1, 0, 5),    # tangent: delta == 0, t = 5
        ],
        [
            (0, 0, -1),
            (0, 0, -1),
            (0, 0, -1),
            (0, 0, -1),
            (0, 0, -1),
        ],
    )
    t, obj, N = intersect_spheres(O, u, tab)
    t = np.asarray(t)
    obj = np.asarray(obj)
    assert np.allclose(t[0], 4.0, atol=1e-5) and obj[0] == 0
    assert np.allclose(t[1], 1.0, atol=1e-5) and obj[1] == 0
    assert obj[2] == -1 and t[2] == INF
    assert obj[3] == -1
    assert np.allclose(t[4], 5.0, atol=1e-3) and obj[4] == 0
    # Normals: outward unit
    N = np.stack([np.asarray(N.x), np.asarray(N.y), np.asarray(N.z)], -1)
    assert np.allclose(N[0], [0, 0, 1], atol=1e-5)
    # Inside hit: normal points from center through exit point (0,0,-1)
    assert np.allclose(N[1], [0, 0, -1], atol=1e-5)


def test_two_spheres_nearest_and_tie():
    tab = SphereTable.from_list(
        [((0.0, 0.0, 0.0), 1.0), ((0.0, 0.0, 2.0), 1.0)]
    )
    O, u = _rays([(0, 0, 10), (0, 0, -10)], [(0, 0, -1), (0, 0, 1)])
    t, obj, _ = intersect_spheres(O, u, tab)
    assert np.asarray(obj)[0] == 1  # nearer sphere along -z from +z side
    assert np.asarray(obj)[1] == 0


def test_lowest_id_wins_exact_tie():
    # Two identical spheres: the reference's ascending scan with strict `<`
    # keeps the first (global_launcher.cu:720-731).
    tab = SphereTable.from_list(
        [((0.0, 0.0, 0.0), 1.0), ((0.0, 0.0, 0.0), 1.0)]
    )
    O, u = _rays([(0, 0, 5)], [(0, 0, -1)])
    _, obj, _ = intersect_spheres(O, u, tab)
    assert np.asarray(obj)[0] == 0


def test_matches_oracle_random(rng):
    from raytracinggpu.oracle.numpy_ref import OracleScene

    spheres = [
        (tuple(rng.uniform(-5, 5, 3)), float(rng.uniform(0.5, 3.0)))
        for _ in range(5)
    ]
    mats = [((1.0, 1.0, 1.0), False, 1.0, 1.0)] * 5
    osc = OracleScene(spheres, mats, L=(0, 0, 0), intensity=1.0)
    n = 256
    o = rng.uniform(-10, 10, (n, 3)).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    O, u = _rays(o, d)
    t, obj, _ = intersect_spheres(O, u, SphereTable.from_list(spheres))
    t0, obj0, _ = osc.intersect_spheres(
        o, np.asarray(d / np.linalg.norm(d, axis=1, keepdims=True), np.float32)
    )
    np.testing.assert_array_equal(np.asarray(obj), obj0)
    hit = obj0 >= 0
    np.testing.assert_allclose(np.asarray(t)[hit], t0[hit], rtol=2e-4, atol=2e-4)

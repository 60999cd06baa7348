"""The BVH walk kernel (ops/walk.py) in the Pallas interpreter vs the dense
reference (ops/triangle.intersect_tris_dense).

Closest hit: the hit/miss classification must agree exactly, the winning
triangle on all but rare exact ties, and t where the winners agree to 1e-5
relative plus the conditioning of t = (A.Ng - O.Ng)/(u.Ng) (both sides
evaluate the same factorized Moller-Trumbore algebra; only summation order
and FMA contraction differ).  Shadow
(any-hit): the occlusion predicate t*t <= cap2 must agree exactly on
active lanes, and inactive lanes return INF.

Every case uses a ray count that is not a multiple of the block, so the
padding lanes are exercised too.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytracinggpu.accel.bvh import build_bvh
from raytracinggpu.accel.lbvh import build_lbvh
from raytracinggpu.core.vec import Vec3
from raytracinggpu.ops.sphere import INF
from raytracinggpu.ops.triangle import intersect_tris_dense
from raytracinggpu.ops.walk import (
    BLOCKS,
    NODE_I,
    intersect_tris_walk,
    intersect_tris_walk_shadow,
)
from raytracinggpu.scene.mesh import MeshData
from raytracinggpu.scene.presets import wall_spheres
from raytracinggpu.scene.scene import build_scene_tables

R = 300  # not a multiple of any block size
SCENES = ["cat", "cat_lbvh", "soup20k", "leaf73", "dup_tie", "posed_cat",
          "sphere_cap"]


def _tables(A, B, C, builder="reference"):
    """Scene tables (dense + walk) for a raw triangle soup."""
    A, B, C = (np.asarray(v, np.float32) for v in (A, B, C))
    bvh = (build_lbvh if builder == "lbvh" else build_bvh)(A, B, C)
    o = bvh.order
    z = np.zeros_like(A)
    mesh = MeshData(A=A[o].copy(), B=B[o].copy(), C=C[o].copy(),
                    na=z, nb=z, nc=z, bvh=bvh, n_vertices=3 * len(A),
                    n_normals=0)
    spheres, mats = wall_spheres(990.0)
    return build_scene_tables(spheres, mats, L=(-10, 20, 40),
                              intensity=3e10, mesh=mesh)


def _cat(cat_mesh_raw, builder="reference"):
    V = cat_mesh_raw.vertices * 0.6 + np.float32([0, -10, 0])
    vtx = cat_mesh_raw.vtx
    return V[vtx[:, 0]], V[vtx[:, 1]], V[vtx[:, 2]]


def _soup(n, seed=5, spread=20.0, size=0.6):
    rng = np.random.default_rng(seed)
    A = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    B = A + rng.standard_normal((n, 3)).astype(np.float32) * size
    C = A + rng.standard_normal((n, 3)).astype(np.float32) * size
    return A, B, C


def _big_leaf(n_fan=73):
    """A fan of n_fan triangles sharing one centroid (the midpoint split
    cannot separate them, so they land in one leaf) beside a small soup."""
    ang = np.linspace(0, np.pi, n_fan, endpoint=False)
    d = np.stack([np.cos(ang), np.sin(ang), 0 * ang], 1) * 4.0
    e = np.float32([0, 0, 3.0])
    A = (d + e).astype(np.float32)
    B = (-d + e).astype(np.float32)
    C = np.tile(np.float32([0, 0, -6.0]), (n_fan, 1))
    sA, sB, sC = _soup(40, seed=9, spread=10.0, size=1.5)
    return (np.concatenate([A, sA]), np.concatenate([B, sB]),
            np.concatenate([C, sC]))


def _dup_tie():
    """Six coincident copies of one triangle among other triangles: the
    lowest index must win the exact t tie (global_launcher.cu:268-278)."""
    tri = np.float32([[-6, -6, 0], [6, -6, 0], [0, 6, 0]])
    sA, sB, sC = _soup(30, seed=11, spread=12.0, size=1.0)
    A = np.concatenate([sA, np.tile(tri[0], (6, 1))])
    B = np.concatenate([sB, np.tile(tri[1], (6, 1))])
    C = np.concatenate([sC, np.tile(tri[2], (6, 1))])
    return A, B, C


def _sphere_cap(n_lat=12, n_lon=24, radius=12.0, max_lat=np.pi / 3):
    """Tessellated spherical cap: smooth curvature, grazing rays at its rim."""
    th = np.linspace(0, max_lat, n_lat + 1)
    ph = np.linspace(0, 2 * np.pi, n_lon + 1)
    P = lambda t, p: radius * np.stack(
        [np.sin(t) * np.cos(p), np.cos(t), np.sin(t) * np.sin(p)], -1)
    A, B, C = [], [], []
    for i in range(n_lat):
        for j in range(n_lon):
            p00, p01 = P(th[i], ph[j]), P(th[i], ph[j + 1])
            p10, p11 = P(th[i + 1], ph[j]), P(th[i + 1], ph[j + 1])
            A += [p00, p00]
            B += [p10, p11]
            C += [p11, p01]
    return (np.float32(A), np.float32(B), np.float32(C))


POSE = (0.8, (2.0, 1.0, -3.0))  # rotation_y angle, translation


@functools.lru_cache(maxsize=None)
def _scene(name):
    """(scene tables, (A, B, C) corners in BVH order in the scene's frame)."""
    from raytracinggpu.scene.obj import CAT_OBJ_PATH, read_obj

    if name in ("cat", "cat_lbvh", "posed_cat"):
        tris = _cat(read_obj(CAT_OBJ_PATH))
        builder = "lbvh" if name == "cat_lbvh" else "reference"
    else:
        tris = {
            "soup20k": lambda: _soup(20_000),
            "leaf73": _big_leaf,
            "dup_tie": _dup_tie,
            "sphere_cap": _sphere_cap,
        }[name]()
        builder = "reference"
    tables = _tables(*tris, builder=builder)
    src = tables.mesh_src
    n = tables.mesh.n_tri
    corners = [np.stack([np.asarray(v.x), np.asarray(v.y), np.asarray(v.z)],
                        1)[:n] for v in (src.A, src.B, src.C)]
    if name == "posed_cat":
        from raytracinggpu.scene.transform import pose_mesh, rotation_y

        ang, t = POSE
        tables = jax.jit(lambda s: pose_mesh(
            s, rotation_y(ang), t=t))(tables)
        M = np.asarray(rotation_y(ang))
        corners = [c @ M.T + np.float32(t) for c in corners]
    return tables, tuple(np.float32(c) for c in corners)


def _rays(name, seed, surface=False):
    """Half the rays aimed at random points of random triangles, half in
    random directions; surface=True starts them ON the mesh instead (the
    bounce-ray situation in which eps_leaf matters)."""
    rng = np.random.default_rng(seed)
    A, B, C = _scene(name)[1]
    k = rng.integers(0, len(A), R)
    w = rng.dirichlet([1.0, 1.0, 1.0], R).astype(np.float32)
    P = w[:, :1] * A[k] + w[:, 1:2] * B[k] + w[:, 2:] * C[k]
    d = rng.standard_normal((R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    if surface:
        O = P
    else:
        O = rng.uniform(-30, 30, (R, 3)).astype(np.float32)
        aim = P - O
        aim /= np.linalg.norm(aim, axis=1, keepdims=True)
        d[: R // 2] = aim[: R // 2]
    vec = lambda a: Vec3(*(jnp.asarray(a[:, i]) for i in range(3)))
    return vec(O), vec(d.astype(np.float32))


def _check_closest(tables, O, u, eps_leaf, block):
    wh = intersect_tris_walk(O, u, tables.walk, eps_leaf, block=block)
    dh = intersect_tris_dense(O, u, tables.mesh, eps_leaf)
    t_w, t_d = np.asarray(wh.t), np.asarray(dh.t)
    hit = t_d < INF
    np.testing.assert_array_equal(t_w < INF, hit)
    assert hit.sum() > R // 4, "too few hits to say anything"
    same = np.asarray(wh.idx)[hit] == np.asarray(dh.idx)[hit]
    assert same.mean() >= 0.995, f"winners differ on {(~same).sum()} rays"
    # t = (A.Ng - O.Ng) / denom: when the two dot products nearly cancel
    # the last-bit differences of their sums grow by their size over the
    # result, so the bound adds that conditioning term to 1e-5 relative.
    mt = np.asarray(tables.mesh.mt, np.float64)
    k = np.asarray(dh.idx)[hit][same]
    o = np.stack([np.asarray(c) for c in O], 1)[hit][same].astype(np.float64)
    d = np.stack([np.asarray(c) for c in u], 1)[hit][same].astype(np.float64)
    ng = mt[0:3, 0, k].T
    cond = (np.abs((o * ng).sum(1)) + np.abs(mt[9, 3, k])) / np.abs(
        (d * ng).sum(1))
    err = np.abs(t_w[hit][same] - t_d[hit][same])
    bound = 1e-5 * np.abs(t_d[hit][same]) + 8 * np.finfo(np.float32).eps * cond
    assert (err <= bound).all(), (err / bound).max()
    # Barycentrics are ratios of numerators with cancellation (the
    # factorized form), so grazing hits carry a few 1e-3 of rounding; the
    # bulk must agree far tighter.
    for a, b in ((wh.beta, dh.beta), (wh.gamma, dh.gamma)):
        d = np.abs(np.asarray(a)[hit][same] - np.asarray(b)[hit][same])
        assert d.max() < 1e-2 and np.median(d) < 1e-6, (d.max(), np.median(d))
    assert np.asarray(wh.t).shape == (R,)
    return wh, dh


def _check_shadow(tables, O, u, eps_leaf, block, seed):
    rng = np.random.default_rng(seed)
    cap2 = jnp.asarray(rng.uniform(0.0, 45.0, R).astype(np.float32) ** 2)
    active = jnp.asarray(rng.random(R) < 0.7)
    ts = np.asarray(intersect_tris_walk_shadow(
        O, u, tables.walk, eps_leaf, cap2, active=active, block=block))
    td = np.asarray(intersect_tris_dense(O, u, tables.mesh, eps_leaf).t)
    act = np.asarray(active)
    c2 = np.asarray(cap2)
    occ_w = ts * ts <= c2
    occ_d = td * td <= c2
    np.testing.assert_array_equal(occ_w[act], occ_d[act])
    assert 0 < occ_d[act].sum() < act.sum(), "predicate never varies"
    assert (ts[~act] >= INF).all()
    # non-occluded lanes walk everything: they return the nearest hit
    far = act & ~occ_d
    np.testing.assert_array_equal(ts[far] < INF, td[far] < INF)




@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("name", SCENES)
def test_closest_matches_dense(name, block):
    tables = _scene(name)[0]
    O, u = _rays(name, seed=SCENES.index(name))
    _check_closest(tables, O, u, 1e-4, block)


@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("name", SCENES)
def test_shadow_matches_dense(name, block):
    tables = _scene(name)[0]
    O, u = _rays(name, seed=SCENES.index(name) + 100)
    _check_shadow(tables, O, u, 1e-4, block, seed=7)


@pytest.mark.parametrize("eps_leaf", [0.0, 1e-4, 1e-3])
def test_closest_eps_leaf_on_surface_rays(eps_leaf):
    """Rays that start on the mesh (bounce rays): the leaf epsilon decides
    which near-zero hits count (0 in optimized.cu:275, 1e-4 and 1e-3 in
    the other launchers)."""
    tables = _scene("cat")[0]
    O, u = _rays("cat", seed=21, surface=True)
    _check_closest(tables, O, u, eps_leaf, 64)


@pytest.mark.parametrize("eps_leaf", [0.0, 1e-4, 1e-3])
def test_shadow_eps_leaf_on_surface_rays(eps_leaf):
    tables = _scene("cat")[0]
    O, u = _rays("cat", seed=22, surface=True)
    _check_shadow(tables, O, u, eps_leaf, 64, seed=8)


def test_big_leaf_is_really_big():
    """The leaf73 scene holds a leaf of at least 73 triangles, and the cat's
    midpoint build holds its 73-triangle leaf: the inner leaf loop is not
    bounded by a static unroll."""
    for name in ("leaf73", "cat"):
        links = np.asarray(_scene(name)[0].walk.links).reshape(-1, NODE_I)
        assert links[:, 2].max() >= 73, name


def test_duplicate_tie_lowest_index_wins():
    tables = _scene("dup_tie")[0]
    n = 64
    o = np.tile(np.float32([[0.0, -2.0, 20.0]]), (n, 1))
    o[:, :2] += np.random.default_rng(0).uniform(-1, 1, (n, 2))
    d = np.tile(np.float32([[0.0, 0.0, -1.0]]), (n, 1))
    vec = lambda a: Vec3(*(jnp.asarray(a[:, i]) for i in range(3)))
    wh = intersect_tris_walk(vec(o), vec(d), tables.walk, 1e-4)
    dh = intersect_tris_dense(vec(o), vec(d), tables.mesh, 1e-4)
    hit = np.asarray(dh.t) < INF
    assert hit.all()
    np.testing.assert_array_equal(np.asarray(wh.idx), np.asarray(dh.idx))
    np.testing.assert_array_equal(np.asarray(wh.t), np.asarray(dh.t))


def test_shadow_all_inactive_returns_inf():
    tables = _scene("cat")[0]
    O, u = _rays("cat", seed=3)
    ts = intersect_tris_walk_shadow(
        O, u, tables.walk, 1e-4, jnp.full((R,), 1e6, jnp.float32),
        active=jnp.zeros((R,), bool))
    assert (np.asarray(ts) >= INF).all()


def test_block_sizes_agree_bitwise():
    """The block is a scheduling choice: every block size gives the same
    bits."""
    tables = _scene("cat")[0]
    O, u = _rays("cat", seed=4)
    outs = [intersect_tris_walk(O, u, tables.walk, 1e-4, block=b)
            for b in BLOCKS]
    for other in outs[1:]:
        for a, b in zip(outs[0], other):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_unknown_block_rejected():
    tables = _scene("cat")[0]
    O, u = _rays("cat", seed=4)
    with pytest.raises(ValueError, match="block"):
        intersect_tris_walk(O, u, tables.walk, 1e-4, block=48)

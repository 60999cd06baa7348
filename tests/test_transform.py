"""Device-side mesh pose transform (scene/transform.py).

The reference's transform path is dead code (rotation built+uploaded at
realtime_render.cu:1311-1335, transform kernel never called); here it is a
live jitted op, so the tests compare against host-side rebuilds.
"""
import jax
import numpy as np
import pytest

from raytracinggpu.render.pipeline import render_preset_frame
from raytracinggpu.scene.presets import build_preset
from raytracinggpu.scene.transform import pose_mesh, rotation_y


def _small_scene(**over):
    over.setdefault("traversal", "walk")
    return build_preset(
        "array_bvh", width=48, height=48, spp=2, max_depth=2, **over,
    )


def test_identity_pose_is_noop():
    cfg, tables = _small_scene()
    posed = jax.jit(lambda s: pose_mesh(s, rotation_y(0.0)))(tables)
    for a, b in zip(posed.walk, tables.walk):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=0, atol=1e-5)
    np.testing.assert_allclose(
        np.asarray(posed.mesh.mt), np.asarray(tables.mesh.mt),
        rtol=0, atol=1e-5)
    # identity render matches the unposed render bit-for-bit is too strict
    # (field rebuild reassociates float ops); compare tonemapped frames:
    from raytracinggpu.render.image_io import tonemap

    img0, _ = render_preset_frame(tables, cfg, seed=0)
    img1, _ = render_preset_frame(posed, cfg, seed=0)
    d = np.abs(tonemap(img0).astype(int) - tonemap(img1).astype(int))
    assert (d.max(axis=-1) <= 1).mean() > 0.995


def _rot(ang):
    c, s = np.cos(ang), np.sin(ang)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)


def _corners(src, M):
    """Rotated base corners (3, T, 3) of the real (unpadded) triangles."""
    valid = np.asarray(src.valid)
    return np.stack([
        np.stack([np.asarray(v.x), np.asarray(v.y), np.asarray(v.z)],
                 axis=1)[valid] @ M.T for v in (src.A, src.B, src.C)])


def test_walk_leaf_boxes_contain_rotated_vertices():
    """The walk kernel's node records are refit in-jit: every rotated
    vertex lies inside the box of the leaf that holds its triangle."""
    from raytracinggpu.ops.walk import NODE_F, NODE_I

    _, tables = _small_scene()
    ang = 0.7
    posed = jax.jit(lambda s: pose_mesh(s, rotation_y(ang)))(tables)
    nodes = np.asarray(posed.walk.nodes).reshape(-1, NODE_F)
    links = np.asarray(posed.walk.links).reshape(-1, NODE_I)
    V = _corners(tables.mesh_src, _rot(ang))
    n_leaves = 0
    for k in np.nonzero(links[:, 2] > 0)[0]:
        s0, n = links[k, 1], links[k, 2]
        pts = V[:, s0:s0 + n].reshape(-1, 3)
        assert (pts >= nodes[k, 0:3] - 1e-3).all()
        assert (pts <= nodes[k, 3:6] + 1e-3).all()
        n_leaves += 1
    assert n_leaves == int((np.asarray(tables.bvh.right) == -1).sum())


def test_bvh_boxes_contain_rotated_root():
    _, tables = _small_scene()
    ang = -np.pi / 3  # the reference's intended pose (realtime_render.cu:1313)
    posed = jax.jit(lambda s: pose_mesh(s, rotation_y(ang)))(tables)
    src = tables.mesh_src
    valid = np.asarray(src.valid)
    c, s = np.cos(ang), np.sin(ang)
    M = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    root_mn = np.array([float(posed.bvh.mn.x[0]), float(posed.bvh.mn.y[0]),
                        float(posed.bvh.mn.z[0])])
    root_mx = np.array([float(posed.bvh.mx.x[0]), float(posed.bvh.mx.y[0]),
                        float(posed.bvh.mx.z[0])])
    for corner in (src.A, src.B, src.C):
        v = np.stack([np.asarray(corner.x), np.asarray(corner.y),
                      np.asarray(corner.z)], axis=1)[valid] @ M.T
        assert (v >= root_mn - 1e-3).all() and (v <= root_mx + 1e-3).all()


def test_walk_triangles_match_host_tables():
    """The walk's triangle records of a posed scene equal the records of
    tables built on host from the same rotated vertices (BVH order)."""
    from raytracinggpu.ops.triangle import build_tri_tables
    from raytracinggpu.ops.walk import TRI_F, build_walk_tables

    _, tables = _small_scene()
    ang = 0.7
    posed = jax.jit(lambda s: pose_mesh(s, rotation_y(ang)))(tables)
    A, B, C = _corners(tables.mesh_src, _rot(ang))
    Tp = tables.mesh.mt.shape[-1]
    host = build_walk_tables(build_tri_tables(A, B, C, pad_to=Tp),
                             tables.bvh)
    got = np.asarray(posed.walk.tris).reshape(-1, TRI_F)
    want = np.asarray(host.tris).reshape(-1, TRI_F)
    scale = np.abs(want).max(axis=0) + 1.0
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=1e-5)


@pytest.mark.parametrize("traversal", ["walk", "dense"])
def test_rotated_render_matches_host_rebuild(traversal):
    """pose_mesh(R_y(a)) render == render of a scene whose mesh vertices were
    rotated on host before the BVH build.  The BVH differs (topology built
    from rotated centroids) but the geometry is identical, so the images
    agree up to float-reassociation noise on a handful of silhouette paths."""
    ang = 0.9
    cfg, tables = _small_scene(traversal=traversal)
    posed = jax.jit(lambda s: pose_mesh(s, rotation_y(ang)))(tables)
    img_dev, _ = render_preset_frame(posed, cfg, seed=0)

    from raytracinggpu.scene.mesh import build_mesh, rescale, rotate_y
    from raytracinggpu.scene.obj import CAT_OBJ_PATH, read_obj
    from raytracinggpu.scene.presets import build_preset as bp

    obj = read_obj(CAT_OBJ_PATH)
    obj.vertices = rotate_y(
        rescale(obj.vertices, 0.6, (0.0, -10.0, 0.0)), ang)
    mesh = build_mesh(obj)
    cfg2, tables2 = bp("array_bvh", mesh=mesh, width=48, height=48, spp=2,
                       max_depth=2, traversal=traversal)
    img_host, _ = render_preset_frame(tables2, cfg2, seed=0)

    from raytracinggpu.render.image_io import tonemap

    # identical RNG and geometry; only fp tie-breaks may flip a path
    d = np.abs(tonemap(img_dev).astype(int) - tonemap(img_host).astype(int))
    assert (d.max(axis=-1) <= 1).mean() > 0.98


def test_pose_composes_with_translation():
    cfg, tables = _small_scene()
    posed = jax.jit(
        lambda s: pose_mesh(s, rotation_y(0.0), t=(3.0, 0.0, 0.0))
    )(tables)
    from raytracinggpu.ops.walk import NODE_F

    a0 = np.asarray(tables.walk.nodes).reshape(-1, NODE_F)
    a1 = np.asarray(posed.walk.nodes).reshape(-1, NODE_F)
    np.testing.assert_allclose(a1[:, [0, 3]], a0[:, [0, 3]] + 3.0, atol=1e-4)
    np.testing.assert_allclose(a1[:, [1, 2, 4, 5]], a0[:, [1, 2, 4, 5]],
                               atol=1e-4)


def test_realtime_animated_mesh():
    """cfg.animate_mesh spins the cat per frame: frames differ, the mesh
    angle advances, and determinism holds for equal seeds."""
    from raytracinggpu.render.realtime import init_state, step

    cfg, tables = build_preset(
        "realtime", width=32, height=32, spp=2, max_depth=2,
        traversal="walk", animate_mesh=True,
    )
    st = init_state(cfg, tables, seed=0)
    st, d1 = step(tables, cfg, st)
    d1 = np.asarray(d1).copy()  # materialize before the donated next step
    acc1 = np.asarray(st.accum).copy()
    a1 = float(st.mesh_angle)
    st, _d2 = step(tables, cfg, st)
    assert float(st.mesh_angle) > a1 > 0.0
    # the second frame saw a rotated mesh (and fresh RNG): raw radiance
    # accumulation cannot repeat (u8 displays may quantize equal at 32^2)
    assert not np.array_equal(np.asarray(st.accum), 2.0 * acc1)

    st_b = init_state(cfg, tables, seed=0)
    st_b, d1b = step(tables, cfg, st_b)
    assert np.array_equal(d1, np.asarray(d1b))

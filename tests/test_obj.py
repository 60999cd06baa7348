"""OBJ ingestion: cat asset counts, transforms, face-format handling
(readOBJ semantics, global_launcher.cu:378-695)."""
import numpy as np

from raytracinggpu.scene.mesh import build_mesh, rescale, rotate_y
from raytracinggpu.scene.obj import CAT_OBJ_PATH, read_obj


def test_cat_counts(cat_mesh_raw):
    m = cat_mesh_raw
    # Known asset: 2,247 verts / 3,954 tris / 2,152 normals / 2,032 uvs.
    assert m.vertices.shape == (2247, 3)
    assert m.vtx.shape == (3954, 3)
    assert m.normals.shape == (2152, 3)
    assert m.uvs.shape[0] == 2032
    assert (m.vtx >= 0).all() and (m.vtx < 2247).all()
    assert (m.nrm >= 0).all() and (m.nrm < 2152).all()


def test_embed_transform():
    m0 = read_obj(CAT_OBJ_PATH, embed_transform=False)
    m1 = read_obj(CAT_OBJ_PATH, embed_transform=True)
    np.testing.assert_allclose(
        m1.vertices,
        m0.vertices * np.float32(0.8) + np.array([0, -10, 0], np.float32),
        rtol=1e-5,
        atol=1e-4,
    )


def test_face_formats(tmp_path):
    p = tmp_path / "t.obj"
    p.write_text(
        "v 0 0 0\nv 1 0 0\nv 0 1 0\nv 1 1 0\n"
        "vn 0 0 1\nvt 0 0\n"
        "f 1 2 3\n"          # plain
        "f 1/1 2/1 3/1\n"    # v/vt
        "f 1//1 2//1 3//1\n" # v//vn
        "f 1/1/1 2/1/1 3/1/1\n"
        "f 1 2 3 4\n"        # quad -> fan (1,2,3) (1,3,4)
        "f -4 -3 -2\n"       # negative indices
    )
    m = read_obj(str(p))
    assert m.vtx.shape[0] == 7
    np.testing.assert_array_equal(m.vtx[0], [0, 1, 2])
    np.testing.assert_array_equal(m.vtx[4], [0, 1, 2])  # quad tri 1
    np.testing.assert_array_equal(m.vtx[5], [0, 2, 3])  # quad tri 2 (fan)
    np.testing.assert_array_equal(m.vtx[6], [0, 1, 2])  # negative resolved
    assert m.nrm[2, 0] == 0 and m.nrm[0, 0] == -1


def test_rescale_and_rotate():
    v = np.array([[1.0, 2.0, 3.0]], np.float32)
    out = rescale(v, 0.6, (0, -4, 0))
    np.testing.assert_allclose(out, [[0.6, -2.8, 1.8]], rtol=1e-6)
    r = rotate_y(np.array([[1.0, 0.0, 0.0]], np.float32), np.pi / 2)
    np.testing.assert_allclose(r, [[0, 0, -1]], atol=1e-6)


def test_build_mesh_orders_by_bvh(cat_mesh_raw):
    mesh = build_mesh(cat_mesh_raw)
    o = mesh.bvh.order
    V = cat_mesh_raw.vertices
    np.testing.assert_array_equal(mesh.A, V[cat_mesh_raw.vtx[o, 0]])
    np.testing.assert_array_equal(mesh.C, V[cat_mesh_raw.vtx[o, 2]])
    # Vertex normals travel with their triangles.
    N = cat_mesh_raw.normals
    np.testing.assert_array_equal(mesh.na, N[cat_mesh_raw.nrm[o, 0]])


def test_index_zero_rejected(tmp_path):
    """OBJ face indices are 1-based; a literal 0 resolves to -1, which
    numpy fancy indexing would silently wrap to the LAST vertex (review
    r3 finding) — both parser paths must reject it loudly."""
    import pytest

    from raytracinggpu.scene.obj import read_obj

    p = tmp_path / "bad.obj"
    p.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nf 0 1 2\n")
    with pytest.raises(ValueError, match="1-based"):
        read_obj(str(p), native=False)
    # the shared post-parse validation covers the native path too
    with pytest.raises(ValueError, match="1-based"):
        read_obj(str(p))


def test_offset_only_rescale_applied(tmp_path):
    """--obj-offset without --obj-scale must shift the mesh (the CLI
    previously gated the rescale on scale alone and dropped the offset)."""
    import numpy as np

    from raytracinggpu.cli.main import main

    p = tmp_path / "tri.obj"
    p.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n")
    out = tmp_path / "out.png"
    rc = main(["render", "1", "1", "--preset", "array_bvh",
               "--width", "8", "--height", "8", "--traversal", "dense",
               "--obj", str(p), "--obj-offset", "0", "-10", "0",
               "--out", str(out)])
    assert rc == 0 and out.exists()

"""Native C++ runtime (librt_native.so) vs the canonical numpy paths."""
import numpy as np
import pytest

from raytracinggpu import native

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native library not built (make -C native)"
)


def test_obj_parse_matches_python(cat_mesh_raw):
    from raytracinggpu.scene.obj import CAT_OBJ_PATH, read_obj

    py = read_obj(CAT_OBJ_PATH, native=False)
    nat = read_obj(CAT_OBJ_PATH, native=True)
    np.testing.assert_array_equal(nat.vertices, py.vertices)
    np.testing.assert_array_equal(nat.normals, py.normals)
    np.testing.assert_array_equal(nat.vtx, py.vtx)
    np.testing.assert_array_equal(nat.nrm, py.nrm)
    np.testing.assert_array_equal(nat.uv, py.uv)
    np.testing.assert_allclose(nat.uvs[:, :2], py.uvs[:, :2], rtol=1e-6)


def test_obj_parse_long_polygon_face(tmp_path):
    """A 160-corner polygon whose face line exceeds 1024 bytes: the native
    parser must fan-triangulate ALL corners and reassemble split fgets
    fragments (it previously truncated at 64 corners / 1023 bytes,
    silently dropping triangles)."""
    from raytracinggpu.scene.obj import read_obj

    n = 160
    lines = []
    for k in range(n):
        a = 2 * np.pi * k / n
        lines.append(f"v {np.cos(a):.9f} {np.sin(a):.9f} 0.000000000")
        lines.append(f"vt {k / n:.9f} {k / n:.9f}")
        lines.append(f"vn 0.000000000 0.000000000 1.000000000")
    lines.append(
        "f " + " ".join(f"{i + 1}/{i + 1}/{i + 1}" for i in range(n)))
    p = tmp_path / "poly.obj"
    p.write_text("\n".join(lines) + "\n")
    assert len(lines[-1]) > 1024   # exercises the line-reassembly path

    py = read_obj(str(p), native=False)
    nat = read_obj(str(p), native=True)
    assert py.vtx.shape == (n - 2, 3)
    np.testing.assert_array_equal(nat.vtx, py.vtx)
    np.testing.assert_array_equal(nat.vertices, py.vertices)


def test_obj_parse_embed_transform(cat_mesh_raw):
    from raytracinggpu.scene.obj import CAT_OBJ_PATH, read_obj

    py = read_obj(CAT_OBJ_PATH, embed_transform=True, native=False)
    nat = read_obj(CAT_OBJ_PATH, embed_transform=True, native=True)
    np.testing.assert_allclose(nat.vertices, py.vertices, rtol=1e-6, atol=1e-5)


def test_bvh_build_bit_equal(cat_mesh_raw):
    from raytracinggpu.accel.bvh import build_bvh, check_invariants

    obj = cat_mesh_raw
    A = obj.vertices[obj.vtx[:, 0]]
    B = obj.vertices[obj.vtx[:, 1]]
    C = obj.vertices[obj.vtx[:, 2]]
    py = build_bvh(A, B, C, native=False)
    nat = build_bvh(A, B, C, native=True)
    np.testing.assert_array_equal(nat.left, py.left)
    np.testing.assert_array_equal(nat.right, py.right)
    np.testing.assert_array_equal(nat.tri_start, py.tri_start)
    np.testing.assert_array_equal(nat.tri_end, py.tri_end)
    np.testing.assert_array_equal(nat.skip, py.skip)
    np.testing.assert_array_equal(nat.order, py.order)
    np.testing.assert_array_equal(nat.mn, py.mn)
    np.testing.assert_array_equal(nat.mx, py.mx)
    check_invariants(nat, A, B, C)


def test_png_roundtrip(tmp_path):
    from raytracinggpu.render.image_io import read_png, write_png

    rgb = (np.random.default_rng(5).random((16, 24, 3)) * 255).astype(np.uint8)
    p = str(tmp_path / "n.png")
    write_png(p, rgb, native=True)
    np.testing.assert_array_equal(read_png(p), rgb)

"""CLI custom-OBJ and LBVH-builder paths."""
import os

from raytracinggpu.cli.main import main
from raytracinggpu.render.image_io import read_png


def test_render_custom_obj(tmp_path):
    # A ground-plane quad mesh instead of the cat.
    p = tmp_path / "quad.obj"
    # Winding chosen so the geometric normal points up (the reference never
    # flips mesh normals toward the viewer; a downward normal would
    # self-shadow to black).
    p.write_text(
        "v -10 -8 -10\nv 10 -8 -10\nv 10 -8 10\nv -10 -8 10\n"
        "f 4 3 2 1\n"
    )
    out = str(tmp_path / "o.png")
    rc = main([
        "render", "2", "2", "--preset", "array_bvh",
        "--width", "16", "--height", "16",
        "--obj", str(p), "--traversal", "walk", "--out", out,
    ])
    assert rc == 0
    img = read_png(out)
    assert img.shape == (16, 16, 3)
    # The flat (zero-thickness AABB) quad must actually be visible — a
    # strict slab test would cull the planar tile entirely.  Only the gray
    # mesh produces red==green energy (walls here are pure green/blue).
    region = img[8:12, :, :].astype(int)
    mesh_px = (region[..., 0] > 60) & (
        abs(region[..., 0] - region[..., 1]) < 25
    )
    assert mesh_px.sum() >= 3, "flat mesh not visible (culled?)"


def test_render_lbvh_builder(tmp_path):
    out = str(tmp_path / "l.png")
    rc = main([
        "render", "1", "2", "--preset", "array_bvh",
        "--width", "16", "--height", "16",
        "--bvh-builder", "lbvh", "--out", out,
    ])
    assert rc == 0
    assert os.path.exists(out)


def test_showcase_rejects_custom_obj(tmp_path):
    # CLI must mirror api.Renderer's ValueError: the showcase preset builds
    # its own scene and would silently ignore --obj.
    import pytest

    p = tmp_path / "quad.obj"
    p.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n")
    with pytest.raises(SystemExit):
        main([
            "render", "1", "1", "--preset", "showcase",
            "--width", "8", "--height", "8", "--obj", str(p),
        ])

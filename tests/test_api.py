"""High-level Renderer facade."""
import numpy as np

from raytracinggpu import Renderer


def test_render_and_save(tmp_path):
    r = Renderer("showcase", width=16, height=16, spp=1, max_depth=2)
    img = r.render(seed=0)
    assert img.shape == (16, 16, 3) and img.dtype == np.uint8
    hdr, stats = r.render_hdr(seed=0)
    assert hdr.shape == (16, 16, 3) and hdr.dtype == np.float32
    assert int(np.asarray(stats.hit)[0]) == 256
    p = tmp_path / "api.png"
    r.save(str(p))
    assert p.exists()


def test_animate_batched_matches_single():
    r = Renderer("showcase", width=16, height=16, spp=1, max_depth=1)
    a = list(r.animate(4, seed=2, batch=1))
    b = list(r.animate(4, seed=2, batch=2))
    assert len(a) == len(b) == 4
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert a[0].shape == (16, 16, 3) and a[0].dtype == np.uint8


def test_custom_obj(tmp_path):
    p = tmp_path / "tri.obj"
    p.write_text("v -5 -8 -5\nv 5 -8 -5\nv 0 -8 5\nf 1 2 3\n")
    r = Renderer("array_bvh", obj_path=str(p), width=12, height=12,
                 spp=1, max_depth=1, traversal="walk")
    img = r.render()
    assert img.shape == (12, 12, 3)


def test_animate_frames_decorrelated():
    """reset_each must NOT replay the same RNG: with a frozen light, frames
    differ only by their sample noise — they must not be identical."""
    r = Renderer("showcase", width=16, height=16, spp=1, max_depth=2)
    frames = list(r.animate(3, seed=5, light_speed=0.0, reset_each=True))
    assert not np.array_equal(frames[0], frames[1])
    assert not np.array_equal(frames[1], frames[2])


def test_unknown_preset_is_value_error():
    """Renderer('bogus', bvh_builder='lbvh') previously raised a raw
    KeyError from the mesh-transform table before preset validation."""
    import pytest

    from raytracinggpu.api import Renderer

    with pytest.raises(ValueError, match="unknown preset"):
        Renderer("bogus", bvh_builder="lbvh")


def test_smooth_preset_without_normals_falls_back(tmp_path):
    """A custom OBJ without vn records on a smooth-shading preset must
    render finite (geometric-normal fallback), not NaN from Phong
    interpolation of the all-zero normals."""
    import numpy as np
    import pytest

    from raytracinggpu.api import Renderer

    p = tmp_path / "plain.obj"
    p.write_text("v -3 0 10\nv 3 0 10\nv 0 4 10\nf 1 2 3\n")
    with pytest.warns(UserWarning, match="no vertex normals"):
        r = Renderer("realtime", obj_path=str(p), width=16, height=16,
                     spp=1, max_depth=2)
    assert not r.cfg.smooth_normals
    img, _ = r.render_hdr(seed=0)
    assert np.isfinite(np.asarray(img)).all()

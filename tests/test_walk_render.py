"""Whole-frame parity: every preset rendered through the walk kernel
(interpret mode) against the dense reference at the same seed, with
geometric and with smooth (Phong) normals.

Both sides trace the same sample stream; they differ only where a
last-bit difference flips a closest-hit winner (a grazing ray or an exact
tie), which reroutes that sample's path.  So the per-depth lane counts
must agree to a few lanes, the channel means to 1e-3 relative, and after
tonemapping nearly every pixel within 1/255.
"""
import numpy as np
import pytest

from raytracinggpu.render.image_io import tonemap
from raytracinggpu.render.pipeline import render_preset_frame
from raytracinggpu.scene.presets import PRESET_NAMES, build_preset


def _frame(preset, traversal, smooth):
    cfg, tables = build_preset(
        preset, width=48, height=48, spp=2, max_depth=3,
        traversal=traversal, smooth_normals=smooth)
    return render_preset_frame(tables, cfg, seed=1)


@pytest.mark.parametrize("smooth", [False, True], ids=["geom", "smooth"])
@pytest.mark.parametrize("preset", PRESET_NAMES)
def test_walk_frame_matches_dense(preset, smooth):
    img_w, st_w = _frame(preset, "walk", smooth)
    img_d, st_d = _frame(preset, "dense", smooth)
    assert np.isfinite(img_w).all()
    for name, a, b in zip(st_d._fields, st_w, st_d):
        a, b = np.asarray(a, np.int64), np.asarray(b, np.int64)
        assert (np.abs(a - b) <= 1e-3 * b + 2).all(), (name, a, b)
    np.testing.assert_allclose(img_w.mean((0, 1)), img_d.mean((0, 1)),
                               rtol=1e-3, atol=1e-6)
    px = np.abs(tonemap(img_w).astype(int) - tonemap(img_d).astype(int))
    assert (px.max(-1) <= 1).mean() >= 0.99

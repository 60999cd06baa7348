"""Regenerate the MID-RES statistical goldens (CPU backend, dense oracle).

Each preset is rendered at 256x256 / spp 2 / depth 2 with the dense
traversal on the CPU backend — the exact configuration the CI test
(tests/test_golden.py::test_golden_midres) re-renders — and the stored
golden is the 16x16 grid of per-tile mean radiances
(tests/golden/<preset>_256_tiles.npy, (16,16,3) float32).  At 28x the
pixel coverage of the 48^2 bitwise goldens this catches shading/preset
regressions the low-res net cannot.

Why same-platform goldens: renders of the SAME sample stream on two
platforms agree closely on purely-diffuse scenes, but any preset with
specular/refractive materials diverges chaotically — platform
transcendental/rounding differences flip material-branch decisions taken
against RNG uniforms, so single samples follow entirely different paths.
A cross-platform golden would need thresholds too slack to catch real
regressions.

Run: python tests/regen_goldens_midres.py
"""
import os
import sys

import numpy as np

MIDRES = 256
TILE = 16  # tile grid edge: 16x16 tiles of 16x16 px


def tile_means(img: np.ndarray) -> np.ndarray:
    h, w, _ = img.shape
    return img.reshape(TILE, h // TILE, TILE, w // TILE, 3).mean(axis=(1, 3))


GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(GOLDEN_DIR)))

    import jax

    jax.config.update("jax_platforms", "cpu")
    from raytracinggpu.utils.cache import setup_cache

    setup_cache()
    from raytracinggpu.render.pipeline import render_preset_frame
    from raytracinggpu.scene.presets import PRESET_NAMES, build_preset

    assert jax.devices()[0].platform == "cpu"
    for preset in PRESET_NAMES:
        cfg, tables = build_preset(
            preset, width=MIDRES, height=MIDRES, spp=2, max_depth=2,
            traversal="dense")
        img, _ = render_preset_frame(tables, cfg, seed=0)
        tm = tile_means(np.asarray(img)).astype(np.float32)
        np.save(os.path.join(GOLDEN_DIR, f"{preset}_256_tiles.npy"), tm)
        print(preset, "midres golden regenerated; mean", tm.mean())

"""Regenerate the golden renders (run on the CPU backend)."""
import os

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from raytracinggpu.render.image_io import tonemap, write_png  # noqa: E402
from raytracinggpu.render.pipeline import render_preset_frame  # noqa: E402
from raytracinggpu.scene.presets import PRESET_NAMES, build_preset  # noqa: E402

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")

if __name__ == "__main__":
    os.makedirs(GOLDEN_DIR, exist_ok=True)
    for preset in PRESET_NAMES:
        cfg, tables = build_preset(preset, width=48, height=48, spp=2, max_depth=2, traversal="dense")
        img, _ = render_preset_frame(tables, cfg, seed=0)
        np.save(os.path.join(GOLDEN_DIR, f"{preset}_48.npy"), img.astype(np.float32))
        write_png(os.path.join(GOLDEN_DIR, f"{preset}_48.png"), tonemap(img))
        print(preset, "regenerated")

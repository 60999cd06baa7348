"""Golden-image regression: every preset rendered at 48x48/spp2/depth2 with
seed 0 must match the stored goldens (tests/golden/*.npy, generated on the
CPU backend).  Catches any silent change to scene parameters, sampling,
intersection, or compositing.  Regenerate deliberately with
``python tests/regen_goldens.py`` after intentional changes."""
import os

import numpy as np
import pytest

from raytracinggpu.render.pipeline import render_preset_frame
from raytracinggpu.scene.presets import PRESET_NAMES, build_preset

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")


@pytest.mark.parametrize("preset", PRESET_NAMES)
def test_golden_midres(preset):
    """256^2 statistical golden: per-16x16-px-tile mean radiance at 28x the
    pixel coverage of the bitwise 48^2 goldens, same platform and traversal
    as the regen script (CPU backend, dense oracle) so the comparison is
    tight — this is the regression net for shading/preset subtleties 48^2
    can't resolve.  Presets with specular/refractive materials diverge
    chaotically across platforms because transcendental rounding flips
    material-branch decisions taken against RNG uniforms, so the goldens
    are same-platform."""
    from tests.regen_goldens_midres import MIDRES, tile_means

    path = os.path.join(GOLDEN_DIR, f"{preset}_256_tiles.npy")
    golden = np.load(path)
    cfg, tables = build_preset(
        preset, width=MIDRES, height=MIDRES, spp=2, max_depth=2,
        traversal="dense")
    img, _ = render_preset_frame(tables, cfg, seed=0)
    tm = tile_means(np.asarray(img))
    scale = float(np.abs(golden).mean())
    # Outlier-bounded comparison (mirrors the 48^2 test's structure): the
    # bulk of the tiles must be tight, but a small fraction may flip a
    # material branch even on the SAME host — this machine's persistent
    # XLA cache holds CPU programs AOT-compiled with different machine
    # features (prefer-no-scatter/-gather; the loader warns on every run),
    # so the same render alternates between two codegens depending on
    # which programs hit the cache, and transcendental rounding deltas
    # flip specular/RNG branch decisions in a handful of tiles.  A real
    # shading/preset regression moves tiles broadly or grossly, so bound
    # BOTH the outlier fraction and the outliers' magnitude.
    tol = 2e-3 * np.abs(golden) + 2e-4 * scale
    bad = np.abs(tm - golden) > tol
    frac = float(bad.mean())
    assert frac <= 0.06, (
        f"{preset}: {frac:.2%} of 256^2 tile means deviate from the CPU "
        f"golden (codegen branch flips stay under 6%)")
    gross = np.abs(tm - golden) > 0.15 * np.abs(golden) + 2e-3 * scale
    assert not gross.any(), (
        f"{preset}: {int(gross.sum())} tiles deviate grossly (>15%) from "
        f"the CPU golden — not a branch-flip signature")


@pytest.mark.parametrize("preset", PRESET_NAMES)
def test_golden(preset):
    path = os.path.join(GOLDEN_DIR, f"{preset}_48.npy")
    golden = np.load(path)
    cfg, tables = build_preset(preset, width=48, height=48, spp=2, max_depth=2, traversal="dense")
    img, _ = render_preset_frame(tables, cfg, seed=0)
    # Same platform/backend: expect near-bitwise; allow tiny fp wiggle from
    # XLA version-to-version fusion differences.
    bad = np.abs(img - golden) > 1e-4 * np.abs(golden) + 1.0
    frac = bad.any(-1).mean()
    assert frac < 0.005, f"{preset}: {frac:.3%} pixels deviate from golden"

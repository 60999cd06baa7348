"""Benchmark sweep harness.

Parity with the reference's benchmark.py (benchmark.py:1-38): sweep
spp x bounces, multiple repeats, print a matrix of runtimes — plus what it
lacks: device-step-only time (compile excluded), derived Mray/s, and JSON
output for regression tracking (BASELINE.md measurement protocol).
"""
from __future__ import annotations

import json
import time

import numpy as np


def run_sweep(
    preset: str = "array_bvh",
    width: int = 512,
    height: int = 512,
    spps=(1, 2, 4, 8, 16, 32, 64, 128, 256),
    bounces=(1, 2, 3, 4, 5, 6, 7, 8, 9, 10),
    repeats: int = 5,
    traversal: str | None = None,
    out: str | None = None,
    on_cell=None,
    skip=None,
) -> dict:
    import jax

    from raytracinggpu.render.pipeline import (
        Camera,
        render_frame,
        rays_per_frame,
    )
    from raytracinggpu.scene.presets import build_preset

    over = {} if traversal is None else {"traversal": traversal}
    dev = jax.devices()[0]
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    print(f"device: {device}")
    results = {}
    for b in bounces:
        for s in spps:
            if skip is not None and skip(int(s), int(b)):
                continue
            cfg, tables = build_preset(
                preset, width=width, height=height, spp=int(s),
                max_depth=int(b), **over,
            )
            cam = Camera.default(cfg)
            # Wall-clock including compile on the first repeat (benchmark.py
            # measures whole-process wall-clock; we report compile separately).
            t0 = time.perf_counter()
            img, _ = render_frame(tables, cfg, cam, jax.random.PRNGKey(0))
            img.block_until_ready()
            first = time.perf_counter() - t0

            steady = []
            for r in range(max(1, repeats - 1)):
                t0 = time.perf_counter()
                img, _ = render_frame(tables, cfg, cam, jax.random.PRNGKey(r + 1))
                img.block_until_ready()
                steady.append(time.perf_counter() - t0)
            dt = float(np.mean(steady))
            mrays = rays_per_frame(cfg) / dt / 1e6
            results[(s, b)] = {
                "first_s": first,
                "steady_s": dt,
                "mrays": mrays,
            }
            print(f"spp={s:4d} bounces={b:2d}: {dt:.3f}s steady "
                  f"({mrays:8.1f} Mray/s, first {first:.1f}s)")
            if on_cell is not None:
                on_cell(int(s), int(b), results[(s, b)])

    # benchmark.py-style matrix (rows=spp, cols=bounces).
    print("\truntime matrix (s): rows=spp, cols=bounces")
    for s in spps:
        row = " ".join(
            f"{results[(s, b)]['steady_s']:.3f}" if (s, b) in results else "-"
            for b in bounces
        )
        print(f"{s:4d}: {row}")

    if out:
        with open(out, "w") as f:
            json.dump(
                {"device": device,
                 **{f"{s}x{b}": v for (s, b), v in results.items()}},
                f, indent=1)
        print(f"wrote {out}")
    return results

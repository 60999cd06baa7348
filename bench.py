"""Headline benchmark: rays/s for one frame of the cat-mesh scene
(array_bvh preset, 512x512, 32 spp, 5 bounces) on one GPU.

Prints ONE JSON line with the metric, its unit, the frame time and the
device it ran on (platform, device_kind, device count).  Exits non-zero
when JAX finds no GPU: a CPU number is never reported as a device number.

Ray accounting uses the reference formula (BASELINE.md): every depth level
adds one bounce ray and one shadow ray per sample, so
rays = W*H*spp*(2*depth+1).

Usage: python bench.py
"""
from __future__ import annotations

import json
import sys
import time


def main() -> int:
    import jax
    import numpy as np

    from raytracinggpu.utils.cache import setup_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py needs a GPU; JAX found {dev.platform!r}",
              file=sys.stderr)
        return 1
    setup_cache()

    from raytracinggpu.render.pipeline import Camera, rays_per_frame, render_frame
    from raytracinggpu.scene.presets import build_preset

    cfg, tables = build_preset(
        "array_bvh", width=512, height=512, spp=32, max_depth=5)
    cam = Camera.fixed(cfg.camera_c)
    img, _ = render_frame(tables, cfg, cam, jax.random.PRNGKey(0))
    img.block_until_ready()

    times = []
    for i in range(1, 4):
        t0 = time.perf_counter()
        img, _ = render_frame(tables, cfg, cam, jax.random.PRNGKey(i))
        img.block_until_ready()
        times.append(time.perf_counter() - t0)
    dt = float(np.median(times))
    print(json.dumps({
        "metric": "rays_per_sec_cat_512_spp32_d5",
        "value": rays_per_frame(cfg) / dt,
        "unit": "rays/s",
        "frame_s": dt,
        "traversal": cfg.traversal,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())

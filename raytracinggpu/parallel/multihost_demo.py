"""Two-process (DCN-path) demo: run the sharded renderer across processes.

The reference has no multi-node story (SURVEY.md §2.12).  This exercises
the multi-process one end to end WITHOUT a cluster: two local processes,
each owning half of a virtual 8-device CPU mesh, coordinate through
``jax.distributed`` (the same wire path a multi-host deployment uses over
the network) and render one frame with render_frame_sharded.  Each worker
forces the CPU platform before JAX starts (``worker`` below), so the demo
never opens a GPU: one JAX process per card stays the rule.  Process 0 gathers the
row-sharded frame (multihost_utils.process_allgather) and checks it against
a single-process render of the same config.

Run directly (spawns its own workers):

    python -m raytracinggpu.parallel.multihost_demo

or as one worker (the test harness spawns two):

    python -m raytracinggpu.parallel.multihost_demo --worker \
        --coordinator 127.0.0.1:9456 --num-processes 2 --process-id 0
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys

DEVS_PER_PROC = 4


def worker(coordinator: str, num_processes: int, process_id: int,
           out_path: str | None) -> None:
    os.environ["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={DEVS_PER_PROC}"
    )
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )
    import numpy as np

    from raytracinggpu.parallel.sharding import make_mesh, render_frame_sharded
    from raytracinggpu.render.pipeline import Camera, render_frame
    from raytracinggpu.scene.presets import build_preset

    n = len(jax.devices())
    assert n == num_processes * DEVS_PER_PROC, jax.devices()
    mesh = make_mesh(n_px=n // 2, n_sp=2)

    cfg, tables = build_preset(
        "array_bvh", width=32, height=32, spp=4, max_depth=2,
        traversal="dense",
    )
    cam = Camera.default(cfg)
    key = jax.random.PRNGKey(0)
    img, stats = render_frame_sharded(tables, cfg, cam, key, mesh)

    from jax.experimental import multihost_utils

    img_full = multihost_utils.process_allgather(img, tiled=True)
    if process_id == 0:
        ref, _ = render_frame(tables, cfg, cam, key)
        np.testing.assert_allclose(
            np.asarray(img_full), np.asarray(ref), rtol=1e-5, atol=1e-2
        )
        msg = (
            f"multihost OK: {num_processes} processes x {DEVS_PER_PROC} "
            f"devices, mesh px={n // 2} sp=2, frame {cfg.height}x{cfg.width},"
            " gathered == single-process"
        )
        print(msg)
        if out_path:
            with open(out_path, "w") as f:
                f.write(msg + "\n")


def launch(num_processes: int = 2, port: int = 9456) -> int:
    """Spawn the workers and wait; returns 0 on success."""
    coord = f"127.0.0.1:{port}"
    procs = []
    for pid in range(num_processes):
        env = dict(os.environ)
        env.pop("XLA_FLAGS", None)
        procs.append(subprocess.Popen(
            [sys.executable, "-m",
             "raytracinggpu.parallel.multihost_demo", "--worker",
             "--coordinator", coord,
             "--num-processes", str(num_processes),
             "--process-id", str(pid)],
            env=env,
        ))
    rc = 0
    for p in procs:
        rc |= p.wait()
    return rc


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--coordinator", default="127.0.0.1:9456")
    ap.add_argument("--num-processes", type=int, default=2)
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if args.worker:
        worker(args.coordinator, args.num_processes, args.process_id, args.out)
    else:
        sys.exit(launch(args.num_processes))


if __name__ == "__main__":
    main()

"""Multi-chip rendering over a jax device mesh.

The reference is single-process single-GPU — its only parallelism is the CUDA
pixel grid and the thread-per-(pixel, sample) ablation
(shared_memory_bigger_grid.cu:810,771; SURVEY.md §2.12).  The scale-out
here replaces both axes with a 2D device mesh:

- ``px`` axis: pixel-row tiles, sharding the frame across chips (the analog
  of the CUDA 2D grid, global_launcher.cu:949-950),
- ``sp`` axis: sample (SPP) parallelism with a ``psum`` to merge the
  per-chip sample accumulators (the analog of "bigger grid" sample
  parallelism plus the host averaging loop it needed).

Scene/BVH tables are tiny (~a few MB) and replicated.  RNG draws are keyed
per (sample, global row) — see render.pipeline.row_uniforms — so any mesh
shape produces bit-identical frames to a single device when the fusion
groups align with the sample shard (``spp_fuse = spp / n_sp``).  The mesh
follows the algorithm, not a network topology: every GPU of a host reaches
every other at the same rate.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from raytracinggpu.render.pipeline import Camera, render_rows
from raytracinggpu.scene.scene import RenderConfig, SceneTables


def make_mesh(n_px: int | None = None, n_sp: int = 1, devices=None) -> Mesh:
    """Build a (px, sp) device mesh; defaults to all devices on the px axis."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    if n_px is None:
        n_px = len(devices) // n_sp
    assert n_px * n_sp == len(devices), (n_px, n_sp, len(devices))
    return Mesh(devices.reshape(n_px, n_sp), ("px", "sp"))


@functools.lru_cache(maxsize=None)
def _sharded_render_fn(cfg: RenderConfig, mesh: Mesh):
    n_px, n_sp = mesh.shape["px"], mesh.shape["sp"]
    H, spp = cfg.height, cfg.spp
    assert H % n_px == 0, f"height {H} not divisible by px={n_px}"
    assert spp % n_sp == 0, f"spp {spp} not divisible by sp={n_sp}"
    rows_per = H // n_px
    spp_per = spp // n_sp

    def shard_body(scene, cam, key):
        ip = jax.lax.axis_index("px")
        isp = jax.lax.axis_index("sp")
        rows = ip * rows_per + jnp.arange(rows_per, dtype=jnp.int32)
        sample_ids = isp * spp_per + jnp.arange(spp_per)  # traced via axis_index
        acc, stats = render_rows(scene, cfg, cam, key, rows, sample_ids)
        acc = jax.tree.map(lambda a: jax.lax.psum(a, "sp"), acc)
        stats = jax.tree.map(lambda s: jax.lax.psum(s, ("px", "sp")), stats)
        col = acc / np.float32(spp)
        img = jnp.stack([c.reshape(rows_per, cfg.width) for c in col], axis=-1)
        return img, stats

    return jax.jit(
        jax.shard_map(
            shard_body,
            mesh=mesh,
            in_specs=(P(), P(), P()),              # scene/camera/key replicated
            out_specs=(P("px", None, None), P()),  # frame row-sharded over px
            # Replication of scan carries is managed manually (explicit psum
            # over 'sp'); skip the varying-manual-axes check.
            check_vma=False,
        )
    )


def render_frame_sharded(
    scene: SceneTables,
    cfg: RenderConfig,
    cam: Camera,
    key,
    mesh: Mesh,
):
    """Data+sample-parallel frame render.

    Each device renders its row tile over its sample slice; sample partials
    merge with a ``psum`` over the ``sp`` axis; the frame
    stays row-sharded over ``px`` in the output sharding.
    Requires H % n_px == 0 and spp % n_sp == 0.
    """
    return _sharded_render_fn(cfg, mesh)(scene, cam, key)


def initialize_multihost(coordinator: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None) -> Mesh:
    """Multi-host (DCN) setup: initialize jax.distributed and build the
    global (px, sp) mesh over all hosts' devices.

    The reference has no multi-node story at all (SURVEY.md §2.12); this is
    the scale-out across hosts: collectives inside a host, the network only
    for the frame gather at the end (the row-sharded output is fetched with
    jax.device_get per host or assembled via
    multihost_utils.process_allgather).  Launch one process per host:

        JAX_COORDINATOR=host0:1234 python render.py  (or pass args)

    Single-process (this repo's test rig) falls through to a local mesh.
    """
    import jax

    if num_processes is not None and num_processes > 1:
        jax.distributed.initialize(
            coordinator_address=coordinator,
            num_processes=num_processes,
            process_id=process_id,
        )
    devices = np.asarray(jax.devices())
    n_sp = 2 if len(devices) % 2 == 0 and len(devices) > 1 else 1
    return make_mesh(n_px=len(devices) // n_sp, n_sp=n_sp, devices=devices)

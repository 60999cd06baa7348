"""Sharded rendering == single-device BITWISE when the sample-fusion group
aligns with the sample shard, for the dense reference and for the BVH walk
kernel running under per-device row shards.

Alignment rule: with cfg.spp_fuse == spp // n_sp, the single-chip path
scans n_sp fusion groups sequentially (acc = ((0 + G0) + G1) ...) and each
sp-shard device computes exactly one group G_i with identical code, merged
by psum over the sp axis — both sides reduce the identical partials in
ascending device order, so frames match bit for bit.
"""
import jax
import numpy as np
import pytest

from raytracinggpu.parallel.sharding import make_mesh, render_frame_sharded
from raytracinggpu.render.pipeline import Camera, render_frame
from raytracinggpu.scene.presets import build_preset


def _render_both(cfg, tables, n_px, n_sp, seed=7):
    cam = Camera.fixed(cfg.camera_c)
    key = jax.random.PRNGKey(seed)
    ref, _ = render_frame(tables, cfg, cam, key)
    mesh = make_mesh(n_px=n_px, n_sp=n_sp)
    img, _ = render_frame_sharded(tables, cfg, cam, key, mesh)
    return np.asarray(ref), np.asarray(img)


@pytest.mark.parametrize("n_px,n_sp,spp", [(4, 2, 4), (2, 4, 8), (4, 2, 8)])
def test_sharded_bitwise_when_fuse_aligned(n_px, n_sp, spp):
    cfg, tables = build_preset(
        "global", width=16, height=16, spp=spp, max_depth=2,
        traversal="dense", spp_fuse=spp // n_sp,
    )
    ref, img = _render_both(cfg, tables, n_px, n_sp)
    np.testing.assert_array_equal(img, ref)


def test_sharded_walk_lbvh(cat_mesh_raw):
    """The walk kernel (interpret mode on CPU) over an LBVH-built cat under
    a (px x sp) mesh: each device walks its own row shard against the
    replicated tables; aligned fuse -> bitwise equality."""
    from raytracinggpu.scene.mesh import build_mesh

    mesh_data = build_mesh(cat_mesh_raw, builder="lbvh")
    cfg, tables = build_preset(
        "array_bvh", mesh=mesh_data, width=32, height=32, spp=2,
        max_depth=2, traversal="walk", spp_fuse=1,
    )
    ref, img = _render_both(cfg, tables, 4, 2)
    np.testing.assert_array_equal(img, ref)


def test_sharded_walk_kernel(cat_mesh_raw):
    """The walk traversal (interpret mode on CPU) under an (px x sp) mesh:
    per-device row shards shrink R per device below one kernel block
    multiple, exercising the padding; aligned fuse -> bitwise equality."""
    from raytracinggpu.scene.mesh import build_mesh

    mesh_data = build_mesh(cat_mesh_raw)
    cfg, tables = build_preset(
        "array_bvh", mesh=mesh_data, width=20, height=16, spp=2,
        max_depth=2, traversal="walk", spp_fuse=1,
    )
    assert tables.walk is not None
    ref, img = _render_both(cfg, tables, 4, 2)
    np.testing.assert_array_equal(img, ref)

"""Additional multi-device coverage: mesh construction helpers and the cat
scene sharded across the 8-CPU-device mesh."""
import jax
import numpy as np

from raytracinggpu.parallel.sharding import (
    initialize_multihost,
    make_mesh,
    render_frame_sharded,
)
from raytracinggpu.render.pipeline import Camera, render_frame


def test_initialize_multihost_single_process():
    mesh = initialize_multihost()  # no distributed init in single process
    assert mesh.shape["px"] * mesh.shape["sp"] == len(jax.devices())


def test_sharded_cat_scene_matches(cat_mesh_raw):
    from raytracinggpu.scene.mesh import build_mesh
    from raytracinggpu.scene.presets import build_preset

    mesh_data = build_mesh(cat_mesh_raw)
    cfg, tables = build_preset(
        "array_bvh", mesh=mesh_data, width=16, height=16, spp=2, max_depth=2,
        traversal="walk",
    )
    cam = Camera.fixed(cfg.camera_c)
    key = jax.random.PRNGKey(5)
    ref, _ = render_frame(tables, cfg, cam, key)
    dmesh = make_mesh(n_px=8, n_sp=1)
    img, stats = render_frame_sharded(tables, cfg, cam, key, dmesh)
    np.testing.assert_allclose(np.asarray(img), np.asarray(ref), rtol=1e-6, atol=1e-2)

"""Progressive/realtime loop: accumulation math, light orbit, camera keys,
checkpoint/resume (realtime_render.cu semantics, SURVEY.md §2.9-2.10)."""
import numpy as np
import jax
import jax.numpy as jnp

from raytracinggpu.render.realtime import (
    RenderState,
    init_state,
    on_key,
    orbit_light,
    reset_accumulation,
    step,
)
from raytracinggpu.scene.presets import build_preset, make_config, wall_spheres
from raytracinggpu.scene.scene import build_scene_tables


def _rt_scene(W=16, H=16, spp=2, depth=2):
    spheres, mats = wall_spheres(940.0)
    cfg = make_config(
        "realtime", mesh_object_id=-1, n_objects=6,
        width=W, height=H, spp=spp, max_depth=depth,
    )
    tables = build_scene_tables(spheres, mats, L=(0, 15, 40), intensity=3e10, mesh=None)
    return cfg, tables


def test_orbit_light_preserves_radius_and_height():
    _, tables = _rt_scene()
    r0 = float(np.hypot(np.asarray(tables.L.x), np.asarray(tables.L.z)))
    s2 = orbit_light(tables, jnp.float32(1.2345))
    r1 = float(np.hypot(np.asarray(s2.L.x), np.asarray(s2.L.z)))
    assert np.isclose(r0, r1, rtol=1e-6)
    assert np.isclose(float(np.asarray(s2.L.y)), 15.0)
    # angle is honored
    assert np.isclose(float(np.arctan2(np.asarray(s2.L.z), np.asarray(s2.L.x))), 1.2345, atol=1e-6)


def test_step_accumulates_and_display_is_average():
    from raytracinggpu.core.vec import Vec3

    cfg, tables = _rt_scene()
    st = init_state(cfg, tables, seed=0)
    # Put the camera at the origin: the reference's point-quirk direction
    # (u_center includes cam.C, realtime_render.cu:1115) would otherwise
    # dominate a tiny 16px frame and saturate the whole view.
    st = st._replace(cam_c=Vec3.const(0.0, 0.0, 0.0))
    st1, d1 = step(tables, cfg, st)
    assert int(st1.frames) == 1
    a1 = np.asarray(st1.accum)
    st2, d2 = step(tables, cfg, st1)
    assert int(st2.frames) == 2
    a2 = np.asarray(st2.accum)
    # Light moves every frame => accumulation grows where lit.
    assert (a2 >= a1 - 1e-3).all() and a2.sum() > a1.sum()
    # Display = gamma(accum/frames), uint8 (allow 1 ulp rounding vs float64).
    exp = np.minimum(np.power(np.maximum(a2 / 2, 0), 1 / 2.2), 255.0).astype(np.uint8)
    diff = np.abs(np.asarray(d2).astype(int) - exp.astype(int))
    assert diff.max() <= 1
    # Frames decorrelated (different RNG per frame)
    assert not np.array_equal(np.asarray(d1), np.asarray(d2))


def test_reset_and_keys():
    cfg, tables = _rt_scene()
    st = init_state(cfg, tables, seed=0)
    st, _ = step(tables, cfg, st)
    st2 = on_key(st, "left")
    assert int(st2.frames) == 0 and float(np.abs(np.asarray(st2.accum)).sum()) == 0.0
    # GLUT_KEY_LEFT -> changeYaw(+0.02) (realtime_render.cu:1218)
    assert np.isclose(float(st2.yaw), 0.02)
    st3 = on_key(st2, "w")
    assert np.isclose(float(st3.cam_c.z), 53.0)
    st4 = on_key(st3, "up")
    assert np.isclose(float(st4.pitch), 0.32)
    # unknown key: no reset, no change
    st5 = on_key(st4, "q")
    assert st5 is st4


def test_move_object():
    from raytracinggpu.render.realtime import move_object

    _, tables = _rt_scene()
    t2 = move_object(tables, 1, (1.0, 2.0, -3.0), dt=0.5)
    assert np.isclose(float(t2.spheres.cx[1]) - float(tables.spheres.cx[1]), 0.5)
    assert np.isclose(float(t2.spheres.cy[1]) - float(tables.spheres.cy[1]), 1.0)
    assert np.isclose(float(t2.spheres.cz[1]) - float(tables.spheres.cz[1]), -1.5)
    # other spheres untouched
    assert np.allclose(np.asarray(t2.spheres.cx)[::2], np.asarray(tables.spheres.cx)[::2])


def test_checkpoint_resume_bit_identical(tmp_path):
    from raytracinggpu.utils.checkpoint import load_state, save_state

    cfg, tables = _rt_scene()
    st = init_state(cfg, tables, seed=3)
    for _ in range(2):
        st, _ = step(tables, cfg, st)
    p = str(tmp_path / "ckpt.npz")
    save_state(p, st)

    st_resumed = load_state(p)
    a, disp_a = step(tables, cfg, st_resumed)
    b, disp_b = step(tables, cfg, st)
    np.testing.assert_array_equal(np.asarray(disp_a), np.asarray(disp_b))
    assert int(a.frames) == int(b.frames) == 3


def test_run_loop_smoke(tmp_path):
    from raytracinggpu.render.realtime import run_loop

    cfg, tables = _rt_scene()
    state, summary = run_loop(
        tables, cfg, n_frames=3, out_dir=str(tmp_path), print_every=0
    )
    assert int(state.frames) == 3
    assert summary["frames"] == 3 and summary["fps"] > 0
    import os

    assert sorted(os.listdir(tmp_path)) == [
        "frame_00000.png", "frame_00001.png", "frame_00002.png",
    ]


def test_run_loop_frames_per_dispatch_bit_identical(tmp_path):
    """Micro-batched dispatch (g=2, incl. a remainder batch) must emit the
    SAME frames as g=1 — steps() scans the same step body, so the only
    difference is how many frames ride per device dispatch."""
    import os

    from raytracinggpu.render.realtime import run_loop

    cfg, tables = _rt_scene()
    a, b = tmp_path / "a", tmp_path / "b"
    st1, sum1 = run_loop(tables, cfg, n_frames=3, out_dir=str(a),
                         print_every=0)
    st2, sum2 = run_loop(tables, cfg, n_frames=3, out_dir=str(b),
                         print_every=0, frames_per_dispatch=2)
    assert int(st2.frames) == 3 and sum2["frames"] == 3
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    from raytracinggpu.render.image_io import read_png

    for f in os.listdir(a):
        np.testing.assert_array_equal(read_png(a / f), read_png(b / f))


def test_steps_batch_matches_sequential():
    from raytracinggpu.render.realtime import steps

    cfg, tables = _rt_scene()
    st_a = init_state(cfg, tables, seed=4)
    st_b = init_state(cfg, tables, seed=4)
    st_a, frames = steps(tables, cfg, 3, st_a)
    assert frames.shape == (3, 16, 16, 3)
    for i in range(3):
        st_b, disp = step(tables, cfg, st_b)
        np.testing.assert_array_equal(np.asarray(frames[i]), np.asarray(disp))
    assert int(st_a.frames) == int(st_b.frames) == 3


def test_checkpoint_loads_pre_mesh_angle_layout(tmp_path):
    """Checkpoints saved before RenderState gained mesh_angle (10 leaves)
    still load: mesh_angle defaults to 0 and everything else resumes
    exactly."""
    import jax
    import numpy as np

    from raytracinggpu.render.realtime import init_state
    from raytracinggpu.scene.presets import build_preset
    from raytracinggpu.utils.checkpoint import load_state, save_state

    cfg, tables = build_preset("realtime", width=16, height=16, spp=1,
                               max_depth=1)
    state = init_state(cfg, tables, seed=3)
    leaves, _ = jax.tree.flatten(state)
    # re-save WITHOUT the mesh_angle leaf (index 4), emulating the old layout
    old = leaves[:4] + leaves[5:]
    path = str(tmp_path / "old.npz")
    np.savez(path, *[np.asarray(l) for l in old], treedef="legacy",
             n_leaves=len(old))
    restored = load_state(path)
    assert float(restored.mesh_angle) == 0.0
    np.testing.assert_array_equal(np.asarray(restored.accum),
                                  np.asarray(state.accum))
    np.testing.assert_array_equal(np.asarray(restored.key),
                                  np.asarray(state.key))

    # and the current layout round-trips bit-exactly
    path2 = str(tmp_path / "new.npz")
    save_state(path2, state)
    again = load_state(path2)
    for a, b in zip(jax.tree.leaves(again), jax.tree.leaves(state)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

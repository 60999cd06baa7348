"""Progressive / realtime rendering loop.

GL-free re-design of the reference's interactive renderer
(realtime_render.cu:1244-1298): the CUDA-OpenGL interop pipeline (VBO map ->
kernel -> glDrawArrays) becomes a jitted, donated ``step`` on a render-state
pytree; frames stream to the host as uint8 RGB (PNG sequence / raw pipe)
instead of GL points.

Reproduced semantics:
- progressive accumulation ``accum += frame; display = accum / frames``
  (realtime_render.cu:1136-1139) with gamma pack (realtime_render.cu:1146),
- per-frame RNG decorrelation — WangHash(framenumber) + threadId seeding
  (realtime_render.cu:1105-1106, 1188-1195) becomes ``fold_in(key, frame)``,
- the circulating point light of the README demo: MoveLightSource orbits L
  around the Y axis through the origin (realtime_render.cu:1072-1090 —
  defined but never wired into disp(); here it IS the frame loop's default
  animation, per BASELINE.json config 5),
- interactive camera: yaw/pitch +-0.02 on arrows, +-2 translation on
  a/d/r/f/w/s (realtime_render.cu:1214-1240), with any input resetting the
  accumulation buffer (realtime_render.cu:1246-1251),
- fixed spp=20, max_depth=3 per frame (realtime_render.cu:1264-1265).

The state pytree is serializable (utils/checkpoint.py), which gives the
resume capability the reference lacks (SURVEY.md §5).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from raytracinggpu.core.vec import Vec3
from raytracinggpu.render.pipeline import Camera, render_rows
from raytracinggpu.scene.scene import RenderConfig, SceneTables

YAW_PITCH_STEP = 0.02   # realtime_render.cu:1216-1223
MOVE_STEP = 2.0         # realtime_render.cu:1229-1238


class RenderState(NamedTuple):
    """Everything the progressive loop carries between frames."""

    accum: jnp.ndarray       # (H, W, 3) radiance sum
    frames: jnp.ndarray      # () int32, number of accumulated frames
    rng_frame: jnp.ndarray   # () int32, MONOTONIC frame index for RNG
                             # decorrelation (never reset — resetting the
                             # accumulator must not replay the same samples)
    light_angle: jnp.ndarray # () f32, current orbit angle of L
    mesh_angle: jnp.ndarray  # () f32, current Y-rotation of the mesh pose
                             # (the reference's intended-but-dead transform
                             # path, realtime_render.cu:1311-1335, live here)
    cam_c: Vec3              # camera position (scalars)
    yaw: jnp.ndarray         # () f32
    pitch: jnp.ndarray       # () f32
    key: jax.Array           # base PRNG key


def init_state(cfg: RenderConfig, scene: SceneTables, seed: int = 0) -> RenderState:
    """Initial state matching the reference's start: camera at (0,0,55),
    yaw=0, pitch=0.3 (realtime_render.cu:807-811); the light starts at its
    preset position, converted to (radius, angle) orbit coordinates."""
    lx = float(np.asarray(scene.L.x))
    lz = float(np.asarray(scene.L.z))
    angle = float(np.arctan2(lz, lx))
    return RenderState(
        accum=jnp.zeros((cfg.height, cfg.width, 3), jnp.float32),
        frames=jnp.int32(0),
        rng_frame=jnp.int32(0),
        light_angle=jnp.float32(angle),
        mesh_angle=jnp.float32(0.0),
        cam_c=Vec3.const(*cfg.camera_c),
        yaw=jnp.float32(0.0),
        pitch=jnp.float32(0.3),
        key=jax.random.PRNGKey(seed),
    )


def orbit_light(scene: SceneTables, angle) -> SceneTables:
    """Light position on its Y-axis orbit (MoveLightSource,
    realtime_render.cu:1072-1090): radius preserved in the xz plane,
    height (L.y) unchanged."""
    r = jnp.sqrt(scene.L.x * scene.L.x + scene.L.z * scene.L.z)
    L = Vec3(r * jnp.cos(angle), scene.L.y, r * jnp.sin(angle))
    return scene._replace(L=L)


def _step_impl(scene, cfg, state, angular_speed, dt, mesh_speed):
    angle = state.light_angle + angular_speed * dt
    scene_t = orbit_light(scene, angle)
    mesh_angle = state.mesh_angle
    if cfg.animate_mesh:
        # Spinning-mesh demo: rebuild all mesh tables in-jit from the posed
        # vertices (scene/transform.pose_mesh) — the in-jit form of the
        # reference's transform kernel + re-upload.
        from raytracinggpu.scene.transform import pose_mesh, rotation_y

        mesh_angle = state.mesh_angle + mesh_speed * dt
        scene_t = pose_mesh(scene_t, rotation_y(mesh_angle))
    cam = Camera.from_yaw_pitch(state.cam_c, state.yaw, state.pitch)

    frame_key = jax.random.fold_in(state.key, state.rng_frame)
    rows = np.arange(cfg.height, dtype=np.int32)
    acc, _stats = render_rows(
        scene_t, cfg, cam, frame_key, rows, np.arange(cfg.spp)
    )
    col = acc / np.float32(cfg.spp)
    frame = jnp.stack(
        [c.reshape(cfg.height, cfg.width) for c in col], axis=-1
    )

    from raytracinggpu.render.image_io import tonemap_device

    accum = state.accum + frame
    frames = state.frames + 1
    display = tonemap_device(accum / frames.astype(jnp.float32))

    new_state = state._replace(
        accum=accum, frames=frames, rng_frame=state.rng_frame + 1,
        light_angle=angle, mesh_angle=mesh_angle,
    )
    return new_state, display


@functools.partial(jax.jit, static_argnums=(1,), donate_argnums=(2,))
def step(
    scene: SceneTables,
    cfg: RenderConfig,
    state: RenderState,
    angular_speed=np.float32(1.0),
    dt=np.float32(2e-2),
    mesh_speed=np.float32(1.0),
):
    """One progressive frame: orbit the light (and spin the mesh when
    cfg.animate_mesh), render spp samples, accumulate, and emit the
    gamma-packed display image (uint8).

    Returns (new_state, display_u8 (H, W, 3)).
    """
    return _step_impl(scene, cfg, state, angular_speed, dt, mesh_speed)


@functools.partial(jax.jit, static_argnums=(1, 2, 6), donate_argnums=(3,))
def steps(
    scene: SceneTables,
    cfg: RenderConfig,
    n_frames: int,
    state: RenderState,
    angular_speed=np.float32(1.0),
    dt=np.float32(2e-2),
    reset_each: bool = False,
    mesh_speed=np.float32(1.0),
):
    """Render n_frames progressive frames in ONE dispatch (lax.scan) —
    amortizes the per-dispatch host overhead for offline animation /
    streaming throughput.

    reset_each: clear the accumulator after every emitted frame (crisp
    animation of the moving light) instead of progressive convergence.

    Returns (state, frames_u8 (n, H, W, 3))."""

    def body(st, _):
        st, disp = _step_impl(scene, cfg, st, angular_speed, dt, mesh_speed)
        if reset_each:
            st = reset_accumulation(st)
        return st, disp

    return jax.lax.scan(body, state, None, length=n_frames)


def move_object(scene: SceneTables, index: int, delta, dt: float = 0.2) -> SceneTables:
    """Translate one sphere by v*dt (MoveObject, realtime_render.cu:1092-1098
    — defined in the reference but never launched; live here).  Callers
    should reset the accumulation afterwards, like any scene edit."""
    d = np.asarray(delta, np.float32) * np.float32(dt)
    sel = (jnp.arange(scene.spheres.cx.shape[0]) == index)
    sp = scene.spheres._replace(
        cx=scene.spheres.cx + jnp.where(sel, d[0], 0.0),
        cy=scene.spheres.cy + jnp.where(sel, d[1], 0.0),
        cz=scene.spheres.cz + jnp.where(sel, d[2], 0.0),
    )
    return scene._replace(spheres=sp)


def reset_accumulation(state: RenderState) -> RenderState:
    """buffer_reset semantics (realtime_render.cu:1246-1251): any camera
    input clears the accumulator and restarts frame counting."""
    return state._replace(
        accum=jnp.zeros_like(state.accum), frames=jnp.int32(0)
    )


# ---- interactive camera controls (GLUT key bindings, realtime_render.cu:1214-1240)
def on_key(state: RenderState, keyname: str) -> RenderState:
    """Apply one key event; unknown keys are ignored.  Arrow keys change
    yaw/pitch by 0.02; a/d = x -/+, r/f = y +/-, w/s = z -/+ by 2.  Every
    recognized key resets the accumulation buffer."""
    c = state.cam_c
    upd = {}
    if keyname == "left":
        # GLUT_KEY_LEFT calls changeYaw(+0.02) (realtime_render.cu:1218).
        upd["yaw"] = state.yaw + YAW_PITCH_STEP
    elif keyname == "right":
        upd["yaw"] = state.yaw - YAW_PITCH_STEP
    elif keyname == "up":
        upd["pitch"] = state.pitch + YAW_PITCH_STEP
    elif keyname == "down":
        upd["pitch"] = state.pitch - YAW_PITCH_STEP
    elif keyname == "a":
        upd["cam_c"] = Vec3(c.x - MOVE_STEP, c.y, c.z)
    elif keyname == "d":
        upd["cam_c"] = Vec3(c.x + MOVE_STEP, c.y, c.z)
    elif keyname == "r":
        upd["cam_c"] = Vec3(c.x, c.y + MOVE_STEP, c.z)
    elif keyname == "f":
        upd["cam_c"] = Vec3(c.x, c.y - MOVE_STEP, c.z)
    elif keyname == "w":
        upd["cam_c"] = Vec3(c.x, c.y, c.z - MOVE_STEP)
    elif keyname == "s":
        upd["cam_c"] = Vec3(c.x, c.y, c.z + MOVE_STEP)
    else:
        return state
    return reset_accumulation(state._replace(**upd))


def run_loop(
    scene: SceneTables,
    cfg: RenderConfig,
    n_frames: int,
    seed: int = 0,
    out_dir: str | None = None,
    raw_pipe=None,
    print_every: int = 5,
    angular_speed: float = 1.0,
    mesh_speed: float = 1.0,
    pipelined: bool = True,
    frames_per_dispatch: int = 1,
):
    """Host frame pump (the analog of glutMainLoop + disp,
    realtime_render.cu:1244-1298): steps the jitted renderer, streams frames,
    and prints the per-frame time every ``print_every`` frames like the
    reference (realtime_render.cu:1280-1282).

    pipelined (default): dispatch frame n+1 BEFORE reading frame n back —
    JAX's async dispatch then overlaps the host's dispatch cost with the
    device computing the previous frame, the same overlap the reference gets for free from its
    free-running GLUT pump + async CUDA launches
    (realtime_render.cu:1244-1298).  Frames stream in order, one frame of
    latency.  pipelined=False restores the strict dispatch-wait-read loop.

    frames_per_dispatch (g): micro-batch g frames into ONE steps() scan
    dispatch, amortizing the per-dispatch host cost over g frames; input
    latency grows to ~2g frames.
    Frames are bit-identical to g=1 (steps() scans the same step body).

    Returns (final_state, fps_summary dict).
    """
    import os
    import time

    from raytracinggpu.render.image_io import write_png

    state = init_state(cfg, scene, seed)
    times = []
    speed = np.float32(angular_speed)
    g = max(1, int(frames_per_dispatch))

    def emit(i, display):
        if out_dir is not None:
            os.makedirs(out_dir, exist_ok=True)
            write_png(os.path.join(out_dir, f"frame_{i:05d}.png"),
                      np.asarray(display))
        if raw_pipe is not None:
            raw_pipe.write(np.asarray(display).tobytes())
        if print_every and (i + 1) % print_every == 0:
            import sys

            dt = times[-1]
            # Never interleave text with a raw RGB24 stdout stream.
            print(
                f"frame {i+1}: {dt*1000:.1f} ms ({1.0/dt:.1f} FPS)",
                file=sys.stderr if raw_pipe is not None else sys.stdout,
            )

    def emit_batch(i0, disp):
        """disp: (g', H, W, 3) batch — emit each frame."""
        for j in range(disp.shape[0]):
            emit(i0 + j, disp[j])

    pending = None  # (first index, displays (g', H, W, 3)) not yet read
    t0 = time.perf_counter()
    i = 0
    while i < n_frames:
        gi = min(g, n_frames - i)
        if gi == 1 and g == 1:
            state, display = step(scene, cfg, state, speed,
                                  mesh_speed=np.float32(mesh_speed))
            display = display[None]
        else:
            state, display = steps(scene, cfg, gi, state, speed,
                                   mesh_speed=np.float32(mesh_speed))
        if not pipelined:
            display.block_until_ready()
        if pending is not None:
            pending[1].block_until_ready()
            times.extend([(time.perf_counter() - t0) / pending[1].shape[0]]
                         * pending[1].shape[0])
            emit_batch(*pending)
            pending = None
            # restart AFTER emit: PNG encode / pipe writes are explicitly
            # excluded from the measured frame time (gallery row notes)
            t0 = time.perf_counter()
        if pipelined:
            pending = (i, display)
        else:
            times.extend([(time.perf_counter() - t0) / gi] * gi)
            emit_batch(i, display)
            t0 = time.perf_counter()
        i += gi
    if pending is not None:
        pending[1].block_until_ready()
        times.extend([(time.perf_counter() - t0) / pending[1].shape[0]]
                     * pending[1].shape[0])
        emit_batch(*pending)
    if not times:  # n_frames == 0: no NaN means / IndexError
        return state, {
            "frames": 0, "mean_ms": 0.0, "median_ms": 0.0, "fps": 0.0,
            "first_frame_ms": 0.0,
        }
    steady = times[g:] or times
    return state, {
        "frames": n_frames,
        "mean_ms": float(np.mean(steady) * 1e3),
        "median_ms": float(np.median(steady) * 1e3),
        "fps": float(1.0 / np.mean(steady)),
        "first_frame_ms": float(times[0] * 1e3),
    }

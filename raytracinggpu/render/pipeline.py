"""Single-frame render pipeline.

The wavefront replacement for the per-pixel CUDA launch
(KernelLaunch, global_launcher.cu:883-919; optimized.cu:670-772):

    raygen (camera + Box-Muller jitter)  ->  wavefront trace  ->  average spp

The sample loop is a ``lax.scan`` (sequential, bounding memory to one
wavefront); the ray batch is processed in fixed-size chunks via ``lax.map``
so the dense mode's triangle-block intermediates stay in a few hundred MB
of device memory regardless of resolution.  Everything is one jitted function of
(scene pytree, camera pytree, PRNG key).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from raytracinggpu.core.rng import box_muller_jitter, uniform_open0
from raytracinggpu.core.vec import Vec3
from raytracinggpu.integrator.wavefront import trace
from raytracinggpu.scene.scene import RenderConfig, SceneTables


class Camera(NamedTuple):
    """Camera pytree.

    Fixed-view configs (cpu/global/optimized/array_bvh) use the identity
    basis and C=(0,0,55) with fov pi/3 (global_launcher.cu:900-902).  The
    realtime camera carries a yaw/pitch-derived basis
    (realtime_render.cu:805-861).
    """

    C: Vec3   # position (scalars)
    bx: Vec3  # right
    by: Vec3  # up
    bz: Vec3  # basis z.  NOTE the reference's convention: rotate()
    #           (realtime_render.cu:825-848) seeds bz=(0,0,-1) but
    #           immediately re-derives bz = cross(bx, by) = (0,0,+1) at
    #           yaw=pitch=0; the ray's forward component then comes from
    #           bz * z with z = -W/(2 tan(fov/2)) NEGATIVE.  A camera
    #           built with bz=(0,0,-1) renders the quirk configs BACKWARD.

    @staticmethod
    def fixed(c=(0.0, 0.0, 55.0)) -> "Camera":
        """Identity basis (== from_yaw_pitch(c, 0, 0))."""
        return Camera(
            C=Vec3.const(*c),
            bx=Vec3.const(1.0, 0.0, 0.0),
            by=Vec3.const(0.0, 1.0, 0.0),
            bz=Vec3.const(0.0, 0.0, 1.0),
        )

    @staticmethod
    def default(cfg) -> "Camera":
        """The config's reference-faithful default view: quirk (realtime)
        configs start at the reference camera's initial yaw=0/pitch=0.3
        (realtime_render.cu:807-811); fixed configs use the identity
        basis (their raygen hardcodes the view direction anyway)."""
        if getattr(cfg, "camera_point_quirk", False):
            return Camera.from_yaw_pitch(cfg.camera_c, 0.0, 0.3)
        return Camera.fixed(cfg.camera_c)

    @staticmethod
    def from_yaw_pitch(c, yaw, pitch) -> "Camera":
        """Reference basis construction (realtime_render.cu:825-848):
        yaw about +Y then pitch about the new right axis, re-orthogonalized
        with cross products and normalized."""
        yaw = jnp.float32(yaw)
        pitch = jnp.float32(pitch)
        bx = Vec3.const(1.0, 0.0, 0.0)
        by = Vec3.const(0.0, 1.0, 0.0)
        bz = Vec3.const(0.0, 0.0, -1.0)
        cy, sy = jnp.cos(yaw), jnp.sin(yaw)
        bx = bx * cy + bz * sy
        bz = by.cross(bx)
        cp, sp = jnp.cos(pitch), jnp.sin(pitch)
        by = by * cp - bz * sp
        bz = bx.cross(by)
        return Camera(
            C=Vec3.const(*c) if not isinstance(c, Vec3) else c,
            bx=bx.normalized(),
            by=by.normalized(),
            bz=bz.normalized(),
        )


def pixel_centers(cfg: RenderConfig, rows=None):
    """Per-pixel screen offsets (ux, uy) and the focal z
    (global_launcher.cu:900-904): ux = x - W/2 + 0.5, uy = H/2 - y - 0.5,
    z = -W / (2 tan(fov/2)).

    rows: optional (nr,) array of global row indices (for sharded rendering);
    defaults to all H rows.
    """
    W, H = cfg.width, cfg.height
    x = np.arange(W, dtype=np.float32)
    y = np.arange(H, dtype=np.float32) if rows is None else rows.astype(jnp.float32)
    nr = y.shape[0]
    ux = jnp.broadcast_to((x - W / 2.0 + 0.5)[None, :], (nr, W)).reshape(-1)
    uy = jnp.broadcast_to((H / 2.0 - y - 0.5)[:, None], (nr, W)).reshape(-1)
    z = np.float32(-W / (2.0 * np.tan(cfg.fov / 2.0)))
    return ux, uy, z


def row_uniforms(key_s, rows, W: int, depth: int):
    """Per-(sample, row) keyed uniform draws, shard-invariant by construction:
    each global row folds its own key, so any row partition across chips
    generates identical numbers (the counter-PRNG answer to per-thread
    curand states, global_launcher.cu:887-888).

    Returns (depth+1, 2, nr*W): slot 0 = Box-Muller jitter pair, slots 1..D =
    the diffuse-bounce pair per depth.
    """
    def per_row(r):
        kr = jax.random.fold_in(key_s, r)
        return uniform_open0(kr, (depth + 1, 2, W))

    u = jax.vmap(per_row)(rows)               # (nr, D+1, 2, W)
    u = jnp.moveaxis(u, 0, 2)                 # (D+1, 2, nr, W)
    return u.reshape(depth + 1, 2, -1)


def raygen(cfg: RenderConfig, cam: Camera, gx, gy, rows=None) -> tuple[Vec3, Vec3]:
    """Primary rays for one sample with jitter offsets (gx, gy).

    Fixed configs: u = normalize((ux+gx, uy+gy, z)), O = C
    (global_launcher.cu:904-913).
    Realtime quirk (camera_point_quirk): the reference builds
    u_center = cam.C + bz*z + bx*ux + by*uy — a *point* — and normalizes
    u_center + (gx, gy, 0) as the direction (realtime_render.cu:1112-1123);
    the +C bias and the world-frame jitter are reproduced for parity.
    """
    ux, uy, z = pixel_centers(cfg, rows)
    R = ux.shape[0]
    if cfg.camera_point_quirk:
        d = (
            Vec3(
                jnp.broadcast_to(cam.C.x, (R,)),
                jnp.broadcast_to(cam.C.y, (R,)),
                jnp.broadcast_to(cam.C.z, (R,)),
            )
            + cam.bz * z
            + cam.bx * ux
            + cam.by * uy
        )
        d = Vec3(d.x + gx, d.y + gy, d.z)
    else:
        # Reference fixed view is d = (ux+gx, uy+gy, z) in the identity
        # frame (global_launcher.cu:904-913); applying the basis gives the
        # same values there (multiplies by 0/1, modulo XLA fusion low
        # bits) and honors a caller-supplied rotated camera instead of
        # silently ignoring it.
        d = cam.bx * (ux + gx) + cam.by * (uy + gy) + cam.bz * z
    u = d.normalized()
    O = Vec3(
        jnp.broadcast_to(cam.C.x, (R,)),
        jnp.broadcast_to(cam.C.y, (R,)),
        jnp.broadcast_to(cam.C.z, (R,)),
    )
    return O, u


def _pad_chunks(arr, chunk):
    """Pad trailing ray axis to a multiple of chunk and reshape to
    (n_chunks, chunk, ...)."""
    R = arr.shape[0]
    pad = (-R) % chunk
    if pad:
        arr = jnp.pad(arr, [(0, pad)] + [(0, 0)] * (arr.ndim - 1))
    return arr.reshape(-1, chunk, *arr.shape[1:])


def trace_chunked(scene: SceneTables, cfg: RenderConfig, O: Vec3, u: Vec3, uniforms):
    """Trace a full-frame ray batch in ray chunks of cfg.ray_chunk (the
    chunk bounds the dense mode's (chunk, 4, tri_block) intermediates and
    every mode's per-ray state)."""
    R = u.x.shape[0]
    chunk = min(cfg.ray_chunk, R)
    # uniforms (D, 2, R) -> (n_chunks, D, 2, chunk)
    un = jnp.moveaxis(uniforms, -1, 0)       # (R, D, 2)
    un = _pad_chunks(un, chunk)              # (nc, chunk, D, 2)
    un = jnp.moveaxis(un, 1, -1)             # (nc, D, 2, chunk)
    xs = (
        Vec3(*(_pad_chunks(c, chunk) for c in O)),
        Vec3(*(_pad_chunks(c, chunk) for c in u)),
        un,
    )

    def body(x):
        Oc, uc, un = x
        return trace(scene, cfg, Oc, uc, un)

    n_chunks_eff = xs[2].shape[0]
    if 1 < n_chunks_eff <= max(1, int(cfg.chunk_unroll)):
        # Straight-line the chunk loop: lax.map is a scan whose back-edge
        # serializes chunks.  Bit-identical (same body per chunk).
        outs = [body(jax.tree.map(lambda a: a[i], xs))
                for i in range(n_chunks_eff)]
        colors, stats = jax.tree.map(lambda *ys: jnp.stack(ys), *outs)
    else:
        colors, stats = jax.lax.map(body, xs)
    col = Vec3(*(c.reshape(-1)[:R] for c in colors))
    stats = jax.tree.map(lambda s: jnp.sum(s, axis=0), stats)
    return col, stats


def render_rows(
    scene: SceneTables,
    cfg: RenderConfig,
    cam: Camera,
    key,
    rows,
    sample_ids,
):
    """Accumulated (unaveraged) radiance for a set of global rows over a set
    of global sample ids — the shared core of single-chip and sharded
    rendering.  Returns (color Vec3 (nr*W,), TraceStats summed).

    Samples trace in fused groups of cfg.spp_fuse: each group's rays
    concatenate into one wavefront, so kernels see g-times-larger batches
    per dispatch.  RNG stays keyed per (sample, row); results are bitwise
    independent of the grouping.
    """
    W, D = cfg.width, cfg.max_depth
    R = rows.shape[0] * W
    n_s = int(sample_ids.shape[0])
    g = max(1, min(cfg.spp_fuse, n_s))
    while n_s % g:
        g -= 1
    groups = jnp.asarray(sample_ids).reshape(-1, g)

    def group_body(carry, s_group):
        acc, stats_acc = carry

        def per_sample(s):
            key_s = jax.random.fold_in(key, s)
            un = row_uniforms(key_s, rows, W, D)   # (D+1, 2, R)
            gx, gy = box_muller_jitter(un[0, 0], un[0, 1], np.float32(cfg.sigma))
            O, u = raygen(cfg, cam, gx, gy, rows)
            return O, u, un[1:]

        O, u, un = jax.vmap(per_sample)(s_group)   # leading axis g
        O = Vec3(*(c.reshape(-1) for c in O))
        u = Vec3(*(c.reshape(-1) for c in u))
        # (g, D, 2, R) -> (D, 2, g*R), sample-major like the flattened rays.
        un = jnp.moveaxis(un, 0, 2).reshape(un.shape[1], 2, -1)
        col, stats = trace_chunked(scene, cfg, O, u, un)
        col = Vec3(*(c.reshape(g, R).sum(axis=0) for c in col))
        acc = acc + col
        stats_acc = jax.tree.map(lambda a, b: a + b, stats_acc, stats)
        return (acc, stats_acc), None

    from raytracinggpu.integrator.wavefront import TraceStats

    stats0 = TraceStats(*(jnp.zeros((D,), jnp.int32) for _ in range(6)))
    # spp_unroll: the group scan's back-edge is a sequential barrier (the
    # depth_unroll mechanism one level up).  Bit-identical.
    (acc, stats), _ = jax.lax.scan(
        group_body, (Vec3.zeros((R,)), stats0), groups,
        unroll=max(1, min(int(cfg.spp_unroll), groups.shape[0])),
    )
    return acc, stats


@functools.partial(jax.jit, static_argnums=(1,))
def render_frame(scene: SceneTables, cfg: RenderConfig, cam: Camera, key):
    """Render one frame: (H, W, 3) float32 radiance + summed TraceStats.

    Matches the batch launchers' sample loop (global_launcher.cu:908-917):
    per sample, Box-Muller jitter then a full trace; colors averaged.
    """
    W, H, spp = cfg.width, cfg.height, cfg.spp
    rows = np.arange(H, dtype=np.int32)
    acc, stats = render_rows(scene, cfg, cam, key, rows, np.arange(spp))
    col = acc / np.float32(spp)
    img = jnp.stack([c.reshape(H, W) for c in col], axis=-1)
    return img, stats


def render_preset_frame(scene, cfg, seed: int = 0, cam: Camera | None = None):
    """Convenience host entry: returns (numpy image HxWx3 float32, stats)."""
    if cam is None:
        cam = Camera.default(cfg)
    img, stats = render_frame(scene, cfg, cam, jax.random.PRNGKey(seed))
    return np.asarray(img), jax.tree.map(np.asarray, stats)


def rays_per_frame(cfg: RenderConfig) -> int:
    """Reference ray-count formula (BASELINE.md): every depth adds one bounce
    ray and one shadow ray -> W*H*spp*(2*depth+1)."""
    return cfg.width * cfg.height * cfg.spp * (2 * cfg.max_depth + 1)

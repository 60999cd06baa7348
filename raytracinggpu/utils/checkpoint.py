"""Render-state checkpoint / resume.

The reference has no checkpointing; its closest analog is the realtime
accumulation buffer that is lost on exit and reset on input
(realtime_render.cu:1136-1139, 1246-1251; SURVEY.md §5).  Because the
renderer's whole progressive state is one pytree (RenderState), serializing
it gives exact resume: a restored loop continues producing bit-identical
frames (same fold_in(key, frames) sequence).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from raytracinggpu.core.vec import Vec3
from raytracinggpu.render.realtime import RenderState


def save_state(path: str, state: RenderState) -> None:
    leaves, treedef = jax.tree.flatten(state)
    np.savez(
        path,
        *[np.asarray(l) for l in leaves],
        treedef=str(treedef),
        n_leaves=len(leaves),
    )


def load_state(path: str) -> RenderState:
    data = np.load(path, allow_pickle=False)
    n = int(data["n_leaves"])
    leaves = [jnp.asarray(data[f"arr_{i}"]) for i in range(n)]
    if n == 10:
        # pre-mesh_angle checkpoint (saved before the animated-mesh state
        # existed): splice in the default pose, exact resume otherwise
        leaves.insert(4, jnp.float32(0.0))
    elif n != 11:
        raise ValueError(
            f"unrecognized checkpoint layout: {n} leaves (supported: 10 "
            "[pre-mesh_angle] or 11)")
    # RenderState leaf order: accum, frames, rng_frame, light_angle,
    # mesh_angle, cam_c(Vec3=3), yaw, pitch, key.
    template = RenderState(
        accum=leaves[0],
        frames=leaves[1],
        rng_frame=leaves[2],
        light_angle=leaves[3],
        mesh_angle=leaves[4],
        cam_c=Vec3(leaves[5], leaves[6], leaves[7]),
        yaw=leaves[8],
        pitch=leaves[9],
        key=leaves[10],
    )
    return template

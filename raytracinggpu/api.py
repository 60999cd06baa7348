"""High-level API facade.

One object wrapping the preset/scene/pipeline plumbing for library users
(the reference's 'API' is eleven separate binaries; here one class covers
single frames, progressive animation, and multi-chip rendering):

    from raytracinggpu import Renderer

    r = Renderer("array_bvh", spp=32, max_depth=5)
    image = r.render()                       # (H, W, 3) uint8
    hdr, stats = r.render_hdr(seed=1)        # radiance + TraceStats
    for frame in r.animate(60):              # circulating-light frames
        ...
"""
from __future__ import annotations

from typing import Iterator

import numpy as np


class Renderer:
    """A configured scene + render pipeline.

    Args mirror RenderConfig / the CLI: preset name, resolution, spp,
    max_depth, traversal mode, plus ``obj_path``/``obj_scale``/``obj_offset``
    for custom meshes and ``bvh_builder`` ("reference" | "lbvh").
    """

    def __init__(
        self,
        preset: str = "array_bvh",
        obj_path: str | None = None,
        obj_scale: float | None = None,
        obj_offset=(0.0, 0.0, 0.0),
        bvh_builder: str = "reference",
        **config_overrides,
    ):
        from raytracinggpu.scene.presets import PRESET_NAMES, build_preset

        if preset not in PRESET_NAMES:
            raise ValueError(
                f"unknown preset {preset!r}; choose from {PRESET_NAMES}"
            )
        mesh = None
        if obj_path is not None:
            if preset == "showcase":
                raise ValueError(
                    "the 'showcase' preset has no mesh slot; use a mesh "
                    "preset (e.g. 'array_bvh') with obj_path"
                )
            from raytracinggpu.scene.mesh import build_mesh, rescale
            from raytracinggpu.scene.obj import read_obj

            obj = read_obj(obj_path)
            if obj_scale is not None or tuple(obj_offset) != (0.0, 0.0, 0.0):
                obj.vertices = rescale(
                    obj.vertices,
                    1.0 if obj_scale is None else obj_scale,
                    obj_offset,
                )
            mesh = build_mesh(obj, builder=bvh_builder)
        elif bvh_builder != "reference" and preset != "showcase":
            # Build the preset cat with the requested accel builder.
            from raytracinggpu.scene.mesh import load_cat_mesh
            from raytracinggpu.scene.obj import CAT_OBJ_PATH
            from raytracinggpu.scene.presets import _MESH_TRANSFORM

            embed, s, off = _MESH_TRANSFORM[preset]
            mesh = load_cat_mesh(CAT_OBJ_PATH, embed, s, off,
                                 builder=bvh_builder)
        self.cfg, self.scene = build_preset(
            preset, mesh=mesh, **config_overrides
        )

    # -- single frames ---------------------------------------------------
    def render_hdr(self, seed: int = 0, camera=None):
        """Full-precision radiance image (H, W, 3) float32 + TraceStats."""
        from raytracinggpu.render.pipeline import render_preset_frame

        return render_preset_frame(self.scene, self.cfg, seed=seed, cam=camera)

    def render(self, seed: int = 0, camera=None) -> np.ndarray:
        """Tonemapped uint8 frame (reference gamma-2.2 clamp)."""
        from raytracinggpu.render.image_io import tonemap

        img, _ = self.render_hdr(seed=seed, camera=camera)
        return tonemap(img)

    def save(self, path: str, seed: int = 0, camera=None) -> None:
        from raytracinggpu.render.image_io import write_png

        write_png(path, self.render(seed=seed, camera=camera))

    # -- progressive / animated ------------------------------------------
    def animate(
        self,
        n_frames: int,
        seed: int = 0,
        light_speed: float = 1.0,
        batch: int = 1,
        reset_each: bool = True,
    ) -> Iterator[np.ndarray]:
        """Yield uint8 frames of the circulating-light loop (config 5
        semantics).  batch > 1 renders several frames per device dispatch
        (render.realtime.steps) for streaming throughput; reset_each clears
        the progressive accumulator every frame (crisp animation) instead of
        accumulating (converging still)."""
        from raytracinggpu.render.realtime import (
            init_state,
            reset_accumulation,
            step,
            steps,
        )

        state = init_state(self.cfg, self.scene, seed)
        speed = np.float32(light_speed)
        done = 0
        while done < n_frames:
            # A partial trailing batch would recompile the whole scanned
            # renderer for its length; finish the remainder frame-by-frame.
            if batch > 1 and n_frames - done >= batch:
                state, frames = steps(
                    self.scene, self.cfg, batch, state, speed,
                    reset_each=reset_each,
                )
                for i in range(batch):
                    yield np.asarray(frames[i])
                done += batch
            else:
                state, frame = step(self.scene, self.cfg, state, speed)
                yield np.asarray(frame)
                if reset_each:
                    state = reset_accumulation(state)
                done += 1

    # -- multi-chip -------------------------------------------------------
    def render_sharded(self, seed: int = 0, mesh=None):
        """Render across a jax device mesh (defaults to all devices on the
        pixel axis); returns (radiance, stats)."""
        import jax

        from raytracinggpu.parallel.sharding import (
            make_mesh,
            render_frame_sharded,
        )
        from raytracinggpu.render.pipeline import Camera

        if mesh is None:
            mesh = make_mesh()
        cam = Camera.default(self.cfg)
        img, stats = render_frame_sharded(
            self.scene, self.cfg, cam, jax.random.PRNGKey(seed), mesh
        )
        return np.asarray(img), stats

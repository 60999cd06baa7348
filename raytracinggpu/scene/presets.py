"""The five reference scene configurations (+ a material-showcase scene).

Each reference launcher hardcodes its own copy of the scene with small
parameter deltas (SURVEY.md §2.7 table).  Here every variant is a named
preset so the deltas are explicit and tested:

| preset    | reference main                | notable deltas                          |
|-----------|-------------------------------|-----------------------------------------|
| cpu       | cpu_launcher.cpp:654-725      | sigma=0, eps_bounce=1e-3, mesh v*0.8+(0,-10,0) |
| global    | global_launcher.cu:970-1065   | mesh v*0.48+(0,-10,0) (embed + rescale) |
| optimized | optimized.cu:774-884          | leaf eps 0 (optimized.cu:275)           |
| array_bvh | different-versions/array_bvh.cu:997-1131 | mesh v*0.6+(0,-10,0), no embed |
| realtime  | realtime_render.cu:1301-1386  | L=(0,15,40), floor R=940, fov=pi/2, smooth normals, spp=20/depth=3, camera quirk |

The "showcase" preset materializes the commented-out object library (white /
mirror / nested refractive spheres, cpu_launcher.cpp:668-672,
global_launcher.cu:854,861-863) to exercise every material branch.
"""
from __future__ import annotations

from dataclasses import replace

import numpy as np

from raytracinggpu.scene.mesh import MeshData, load_cat_mesh
from raytracinggpu.scene.obj import CAT_OBJ_PATH
from raytracinggpu.scene.scene import (
    RenderConfig,
    SceneTables,
    build_scene_tables,
)

PRESET_NAMES = ("cpu", "global", "optimized", "array_bvh", "realtime", "showcase")

_WALL_ALBEDOS = {
    "fore": (0.0, 1.0, 0.0),     # green fore wall
    "floor": (0.0, 0.0, 1.0),    # blue floor
    "ceiling": (1.0, 0.0, 0.0),  # red ceiling
    "left": (0.0, 1.0, 1.0),     # cyan left wall
    "right": (1.0, 1.0, 0.0),    # yellow right wall
    "back": (1.0, 0.0, 1.0),     # magenta back wall
}


def wall_spheres(floor_radius: float):
    """The six enclosing wall spheres (global_launcher.cu:855-860); the floor
    radius is 990 in the batch launchers and 940 in realtime
    (realtime_render.cu:1027)."""
    diffuse = lambda alb: (alb, False, 1.0, 1.0)
    spheres = [
        ((0.0, 0.0, -1000.0), 940.0),
        ((0.0, -1000.0, 0.0), floor_radius),
        ((0.0, 1000.0, 0.0), 940.0),
        ((-1000.0, 0.0, 0.0), 940.0),
        ((1000.0, 0.0, 0.0), 940.0),
        ((0.0, 0.0, 1000.0), 940.0),
    ]
    mats = [
        diffuse(_WALL_ALBEDOS["fore"]),
        diffuse(_WALL_ALBEDOS["floor"]),
        diffuse(_WALL_ALBEDOS["ceiling"]),
        diffuse(_WALL_ALBEDOS["left"]),
        diffuse(_WALL_ALBEDOS["right"]),
        diffuse(_WALL_ALBEDOS["back"]),
    ]
    return spheres, mats


_MESH_TRANSFORM = {
    # preset -> (embed 0.8/(0,-10,0) in readOBJ, rescale scale, rescale offset)
    "cpu": (True, None, None),                      # cpu_launcher.cpp:354
    "global": (True, 0.6, (0.0, -4.0, 0.0)),        # global_launcher.cu:410-414,1014
    "optimized": (True, 0.6, (0.0, -4.0, 0.0)),     # optimized.cu:342,804
    "array_bvh": (False, 0.6, (0.0, -10.0, 0.0)),   # array_bvh.cu:1033
    "realtime": (False, 0.6, (0.0, -10.0, 0.0)),    # realtime_render.cu:1309
}


def make_config(preset: str, **overrides) -> RenderConfig:
    base = dict(name=preset)
    if preset == "cpu":
        base.update(sigma=0.0, eps_bounce=1e-3, eps_leaf=1e-4)
    elif preset == "global":
        base.update(sigma=0.2, eps_bounce=1e-4, eps_leaf=1e-4)
    elif preset == "optimized":
        base.update(sigma=0.2, eps_bounce=1e-4, eps_leaf=0.0)
    elif preset == "array_bvh":
        base.update(sigma=0.2, eps_bounce=1e-4, eps_leaf=1e-4)
    elif preset == "realtime":
        base.update(
            sigma=0.2,
            eps_bounce=1e-4,
            eps_leaf=1e-3,                 # realtime_render.cu:298
            fov=float(np.pi / 2),          # realtime_render.cu:1112 (pov)
            smooth_normals=True,
            camera_point_quirk=True,       # realtime_render.cu:1115 adds cam.C
            spp=20,
            max_depth=3,                   # realtime_render.cu:1264-1265
        )
    elif preset == "showcase":
        base.update(
            sigma=0.2,
            eps_bounce=1e-4,
            eps_leaf=1e-4,
            n_objects=10,
            mesh_object_id=-1,
        )
    else:
        raise ValueError(f"unknown preset {preset!r}; choose from {PRESET_NAMES}")
    cfg = RenderConfig(**base)
    return replace(cfg, **overrides) if overrides else cfg


def build_preset(
    preset: str,
    obj_path: str = CAT_OBJ_PATH,
    mesh: MeshData | None = None,
    **config_overrides,
) -> tuple[RenderConfig, SceneTables]:
    """Build (config, device scene tables) for a named preset.

    Pass ``mesh=`` to reuse an already-built MeshData (tests), otherwise the
    cat OBJ is loaded from ``obj_path`` with the preset's transform chain.
    """
    cfg = make_config(preset, **config_overrides)

    if preset == "showcase":
        spheres, mats = wall_spheres(floor_radius=990.0)
        spheres += [
            ((0.0, 0.0, 18.0), 5.0),    # white sphere
            ((-13.0, 0.0, 18.0), 5.0),  # mirror sphere
            ((13.0, 0.0, 18.0), 5.0),   # outer refractive sphere (glass)
            ((13.0, 0.0, 18.0), 4.5),   # inner nested sphere (air bubble)
        ]
        mats += [
            ((1.0, 1.0, 1.0), False, 1.0, 1.0),
            ((0.0, 0.0, 0.0), True, 1.0, 1.0),
            ((0.0, 0.0, 0.0), False, 1.5, 1.0),  # in=1.5, out=1 (glass shell)
            ((0.0, 0.0, 0.0), False, 1.0, 1.5),  # in=1, out=1.5 (bubble)
        ]
        tables = build_scene_tables(
            spheres, mats, L=(-10.0, 20.0, 40.0), intensity=3e10, mesh=None
        )
        return cfg, tables

    floor_r = 940.0 if preset == "realtime" else 990.0
    spheres, mats = wall_spheres(floor_radius=floor_r)
    L = (0.0, 15.0, 40.0) if preset == "realtime" else (-10.0, 20.0, 40.0)

    if mesh is None:
        embed, scale, offset = _MESH_TRANSFORM[preset]
        mesh = load_cat_mesh(obj_path, embed, scale, offset)

    if cfg.smooth_normals and not np.any(mesh.na):
        # Custom OBJ without vertex normals on a smooth-shading preset:
        # Phong interpolation of the all-zero fallback normals would give
        # N=(0,0,0) and NaN bounce frames — fall back to geometric normals.
        import warnings

        warnings.warn(
            "mesh has no vertex normals; smooth_normals disabled "
            "(geometric normals used instead)", stacklevel=2)
        cfg = replace(cfg, smooth_normals=False)

    tables = build_scene_tables(
        spheres,
        mats,
        L=L,
        intensity=3e10,
        mesh=mesh,
        mesh_albedo=(0.25, 0.25, 0.25),
        tri_block=cfg.tri_block,
    )
    return cfg, tables


"""Scene device tables and static render configuration.

The reference hardcodes the scene inside kernels as an array of polymorphic
``Geometry*`` (Scene, global_launcher.cu:841-846) constructed in
``KernelInit<<<1,1>>>`` (global_launcher.cu:848-881).  This design replaces
virtual dispatch with *typed SoA tables* — one sphere table, one triangle-mesh
table — plus a materials table indexed by object id.  ``intersect_all``
becomes two batched intersection passes merged with a min-t select
(semantics of Scene::intersect_all, global_launcher.cu:716-736; object ids
are assigned in insertion order, spheres 0..S-1 then the mesh at id S, same
as the reference's addObject ordering).
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from raytracinggpu.core.vec import Vec3
from raytracinggpu.ops.sphere import SphereTable
from raytracinggpu.ops.triangle import TriTables, build_tri_tables
from raytracinggpu.ops.walk import WalkTables, build_walk_tables
from raytracinggpu.scene.mesh import MeshData


class Materials(NamedTuple):
    """Per-object material columns, indexed by object id (Geometry fields
    albedo/mirror/in_refraction_index/out_refraction_index,
    global_launcher.cu:101-113)."""

    albedo: Vec3        # (M,)
    mirror: jnp.ndarray  # (M,) bool
    in_ri: jnp.ndarray   # (M,)
    out_ri: jnp.ndarray  # (M,)


class BVHTables(NamedTuple):
    """Device copy of the flat BVH (SoA per field + preorder skip links)."""

    left: jnp.ndarray
    right: jnp.ndarray
    tri_start: jnp.ndarray
    tri_end: jnp.ndarray
    skip: jnp.ndarray
    mn: Vec3
    mx: Vec3


class SceneTables(NamedTuple):
    """Everything the integrator needs on device (a single pytree)."""

    spheres: SphereTable
    materials: Materials
    mesh: TriTables | None
    bvh: BVHTables | None
    walk: WalkTables | None  # the BVH walk kernel's records (ops/walk.py)
    L: Vec3          # point light position (scalars)
    intensity: Any   # light intensity (scalar)
    mesh_src: Any = None  # MeshSource | None — BVH-ordered base vertices so
                          # scene/transform.pose_mesh can rebuild every mesh
                          # table in-jit (animated mesh poses)


@dataclass(frozen=True)
class RenderConfig:
    """Static (hashable) parameters of one reference launcher config —
    the per-variant deltas of SURVEY.md §2.7."""

    name: str = "global"
    width: int = 512
    height: int = 512
    spp: int = 32
    max_depth: int = 5          # CLI <num_bounces>
    sigma: float = 0.2          # AA jitter (0 in cpu_launcher.cpp:704)
    eps_bounce: float = 1e-4    # bounce offset (1e-3 CPU, cpu_launcher.cpp:575)
    eps_leaf: float = 1e-4      # mesh leaf t epsilon (see ops/triangle.py)
    fov: float = float(np.pi / 3)
    camera_c: tuple = (0.0, 0.0, 55.0)
    smooth_normals: bool = False   # realtime-only Phong normals
    camera_point_quirk: bool = False  # realtime adds cam.C into the direction
    n_objects: int = 7
    mesh_object_id: int = 6     # -1 when the scene has no mesh
    traversal: str = "walk"     # walk (per-ray BVH walk kernel,
                                # ops/walk.py) | dense | bvh — dense and
                                # bvh are the kernel-free references
    ray_chunk: int = 65536      # rays per inner chunk (memory control)
    spp_fuse: int = 4           # samples folded into one wavefront (the
                                # sample loop runs in groups of this size;
                                # bigger groups = larger ray batches per
                                # cast)
    tri_block: int = 512        # triangle block for the dense scan
    bvh_node_layout: str = "soa"  # node layout for traversal mode 'bvh':
                                # per-field SoA columns vs the reference's
                                # 10-float AoS record row-gathered per step
                                # ('aos10', optimized.cu:512-534) — the
                                # node-layout/gather ablation (SURVEY §2.11)
    bvh_max_leaf: int = 96      # static leaf-unroll bound for traversal
                                # mode 'bvh' (degenerate midpoint partitions
                                # can leave big leaves; the cat's worst is
                                # 73 — build_scene_tables warns when a mesh
                                # exceeds this; the lbvh builder's leaves
                                # are < 5 triangles by construction)
    depth_unroll: int = field(
        default_factory=lambda: int(os.environ.get("RT_DEPTH_UNROLL", "8")))
                                # lax.scan unroll factor for the depth
                                # loop (integrator/wavefront.trace),
                                # clamped to max_depth.  Unrolling hands
                                # XLA the whole depth program, so the
                                # shadow cast of depth d and the closest
                                # cast of depth d+1 may overlap; compile
                                # time grows with the unrolled body.
                                # RT_DEPTH_UNROLL overrides the default
                                # (results are bit-identical by
                                # construction; the test suite pins it to
                                # 1 to keep its compiles small)
    spp_unroll: int = 1         # unroll factor for the sample-group scan
                                # (render/pipeline.render_rows); the same
                                # mechanism one level up.  Bit-identical;
                                # costs compile time
    chunk_unroll: int = 1       # run the ray-chunk loop
                                # (render/pipeline.trace_chunked) as
                                # straight-line code when the frame splits
                                # into <= this many chunks, instead of
                                # lax.map.  Bit-identical; costs compile
                                # time
    animate_mesh: bool = False  # realtime loop: spin the mesh via the jitted
                                # pose transform (scene/transform.py) — the
                                # reference's dead transform path, wired

    @property
    def has_mesh(self) -> bool:
        return self.mesh_object_id >= 0


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def build_scene_tables(
    spheres: list,
    materials: list,
    L,
    intensity: float,
    mesh: MeshData | None,
    mesh_albedo=(0.25, 0.25, 0.25),
    tri_block: int = 512,
) -> SceneTables:
    """Assemble device tables from host data.

    spheres: list of (center(3,), radius); materials: matching list of
    (albedo(3,), mirror, in_ri, out_ri).  The mesh (diffuse, albedo 0.25,
    global_launcher.cu:866) is appended as the last object id.
    """
    mats = list(materials)
    if mesh is not None:
        mats.append((mesh_albedo, False, 1.0, 1.0))
    alb = np.array([m[0] for m in mats], np.float32)
    mirror = np.array([m[1] for m in mats], bool)
    in_ri = np.array([m[2] for m in mats], np.float32)
    out_ri = np.array([m[3] for m in mats], np.float32)

    mesh_tables = None
    bvh_tables = None
    walk_tables = None
    mesh_src = None
    if mesh is not None:
        pad_to = _round_up(mesh.n_tri, tri_block)
        mesh_tables = build_tri_tables(
            mesh.A, mesh.B, mesh.C, mesh.na, mesh.nb, mesh.nc, pad_to=pad_to
        )
        from raytracinggpu.scene.transform import build_mesh_source

        mesh_src = build_mesh_source(mesh, pad_to)
        b = mesh.bvh
        leaves = b.right == -1
        max_leaf = int((b.tri_end - b.tri_start)[leaves].max())
        default_max_leaf = RenderConfig.__dataclass_fields__[
            "bvh_max_leaf"].default
        if max_leaf > default_max_leaf:
            import warnings

            warnings.warn(
                f"BVH has a {max_leaf}-triangle leaf (> the default "
                f"bvh_max_leaf={default_max_leaf}): traversal='bvh' would "
                "skip triangles — "
                "raise RenderConfig.bvh_max_leaf or use builder='lbvh'",
                stacklevel=2,
            )
        bvh_tables = BVHTables(
            left=jnp.asarray(b.left),
            right=jnp.asarray(b.right),
            tri_start=jnp.asarray(b.tri_start),
            tri_end=jnp.asarray(b.tri_end),
            skip=jnp.asarray(b.skip),
            mn=Vec3(*[jnp.asarray(b.mn[:, i]) for i in range(3)]),
            mx=Vec3(*[jnp.asarray(b.mx[:, i]) for i in range(3)]),
        )
        walk_tables = build_walk_tables(mesh_tables, bvh_tables)

    tables = SceneTables(
        spheres=SphereTable.from_list(spheres),
        materials=Materials(
            albedo=Vec3(alb[:, 0], alb[:, 1], alb[:, 2]),
            mirror=jnp.asarray(mirror),
            in_ri=jnp.asarray(in_ri),
            out_ri=jnp.asarray(out_ri),
        ),
        mesh=mesh_tables,
        bvh=bvh_tables,
        walk=walk_tables,
        L=Vec3.const(*np.asarray(L, np.float32)),
        intensity=jnp.float32(intensity),
        mesh_src=mesh_src,
    )
    # Commit every leaf to device once at build: numpy leaves in a jit
    # argument would otherwise be re-uploaded host->device on every call.
    return jax.device_put(tables)

"""Device-side (jitted) mesh pose transforms.

The reference builds a mesh rotation/translation path that is dead code in
both launchers — a -pi/3 Y-rotation matrix is constructed and uploaded
(realtime_render.cu:1311-1335) and a ``transform`` vertex kernel exists
(global_launcher.cu:340-365, realtime_render.cu:415-432) but is never
launched (the call is commented out at global_launcher.cu:1034).  SURVEY.md
§2.10 calls for implementing it as a jitted vertex-transform op; this module
does that: instead of mutating a vertex buffer and re-running a host BVH
build, a **rigid transform rebuilds every derived device table in-jit** from
the BVH-ordered base vertices:

- the Moller-Trumbore feature matrix (ops/triangle.py layout) is recomputed
  from transformed (A, B, C) — pure vector math,
- flat-BVH node boxes are refit conservatively by transforming each box's 8
  corners (exact containment under any affine map; tight under translation),
- the walk kernel's node and triangle records (ops/walk.py) are re-derived
  from those two.

Rigid motion never reorders the midpoint-split BVH's triangle partition
semantics *for traversal correctness* — boxes only need to contain their
triangles — so the tree topology, skip links, and leaf ranges are reused
unchanged.  The whole pose update is O(T) elementwise work (~4k triangles:
microseconds), cheap enough to run per frame inside the realtime loop
(the spinning-cat demo the reference intended but never wired).
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from raytracinggpu.core.vec import Vec3
from raytracinggpu.ops.walk import build_walk_tables


class MeshSource(NamedTuple):
    """BVH-ordered base geometry kept on device so poses can rebuild tables
    in-jit.  All arrays are padded to the table size Tp; ``valid`` masks the
    real triangles (padding stays fully degenerate after any transform)."""

    A: Vec3
    B: Vec3
    C: Vec3
    na: Vec3
    nb: Vec3
    nc: Vec3
    valid: jnp.ndarray  # (Tp,) bool


def rotation_y(angle) -> jnp.ndarray:
    """Y-axis rotation matrix, the pose the reference builds
    (realtime_render.cu:1311-1318).  ``angle`` may be a traced scalar."""
    c, s = jnp.cos(angle), jnp.sin(angle)
    z, o = jnp.zeros_like(c), jnp.ones_like(c)
    return jnp.stack(
        [jnp.stack([c, z, s]), jnp.stack([z, o, z]), jnp.stack([-s, z, c])]
    ).astype(jnp.float32)


def _apply(M, t, v: Vec3, linear_only: bool = False) -> Vec3:
    """v -> M @ v (+ t).  M rows index output axes."""
    out = Vec3(
        M[0, 0] * v.x + M[0, 1] * v.y + M[0, 2] * v.z,
        M[1, 0] * v.x + M[1, 1] * v.y + M[1, 2] * v.z,
        M[2, 0] * v.x + M[2, 1] * v.y + M[2, 2] * v.z,
    )
    if linear_only:
        return out
    return Vec3(out.x + t[0], out.y + t[1], out.z + t[2])


def _tri_tables_jax(A: Vec3, B: Vec3, C: Vec3, na, nb, nc, old):
    """jnp rebuild of ops/triangle.build_tri_tables from SoA corners."""
    from raytracinggpu.ops.triangle import TriTables

    e1 = B - A
    e2 = C - A
    ng = e1.cross(e2)

    Tp = A.x.shape[0]
    m = jnp.zeros((10, 4, Tp), jnp.float32)
    st = lambda v: jnp.stack([v.x, v.y, v.z])
    m = m.at[0:3, 0, :].set(st(ng))
    m = m.at[0:3, 1, :].set(st(e2.cross(A)))
    m = m.at[3:6, 1, :].set(-st(e2))
    m = m.at[0:3, 2, :].set(-st(e1.cross(A)))
    m = m.at[3:6, 2, :].set(st(e1))
    m = m.at[6:9, 3, :].set(-st(ng))
    m = m.at[9, 3, :].set(A.dot(ng))

    corners = jnp.concatenate(
        [st(na).T, st(nb).T, st(nc).T, st(ng).T,
         jnp.zeros((Tp, 4), jnp.float32)], axis=1
    )
    return TriTables(
        mt=m, ng=ng, na=na, nb=nb, nc=nc, cornersT=corners, n_tri=old.n_tri
    )


def _refit_boxes(mn: Vec3, mx: Vec3, M, t):
    """Conservative AABB refit under an affine map: per output axis,
    min/max over the 8 transformed corners — computed without materializing
    corners via the interval form sum_j min/max(M_ij*mn_j, M_ij*mx_j)."""
    lo_c, hi_c = [], []
    mnc = (mn.x, mn.y, mn.z)
    mxc = (mx.x, mx.y, mx.z)
    for i in range(3):
        lo = jnp.full_like(mn.x, float(0.0)) + t[i]
        hi = jnp.full_like(mn.x, float(0.0)) + t[i]
        for j in range(3):
            a = M[i, j] * mnc[j]
            b = M[i, j] * mxc[j]
            lo = lo + jnp.minimum(a, b)
            hi = hi + jnp.maximum(a, b)
        lo_c.append(lo)
        hi_c.append(hi)
    return Vec3(*lo_c), Vec3(*hi_c)


def pose_mesh(scene, M, t=(0.0, 0.0, 0.0)):
    """Return a new SceneTables with the mesh rigidly transformed on device:
    v -> M @ v + t applied to vertices, the linear part to vertex normals
    (M orthogonal — rotations — keeps them unit), and every derived table
    rebuilt in-jit.  The scene must have been built with a mesh."""
    src: MeshSource = scene.mesh_src
    if src is None:
        raise ValueError("scene has no mesh to transform")
    t = jnp.asarray(t, jnp.float32)
    zero = lambda v: Vec3(*(jnp.where(src.valid, c, 0.0) for c in v))
    A = zero(_apply(M, t, src.A))
    B = zero(_apply(M, t, src.B))
    C = zero(_apply(M, t, src.C))
    na = zero(_apply(M, t, src.na, linear_only=True))
    nb = zero(_apply(M, t, src.nb, linear_only=True))
    nc = zero(_apply(M, t, src.nc, linear_only=True))

    mesh = _tri_tables_jax(A, B, C, na, nb, nc, scene.mesh)
    mn, mx = _refit_boxes(scene.bvh.mn, scene.bvh.mx, M, t)
    bvh = scene.bvh._replace(mn=mn, mx=mx)
    return scene._replace(mesh=mesh, bvh=bvh, walk=build_walk_tables(mesh, bvh))


def build_mesh_source(mesh, pad_to: int) -> MeshSource:
    """Host-side: pack MeshData (BVH order) into the padded device pytree."""
    T = mesh.n_tri

    def v(arr):
        a = np.pad(np.asarray(arr, np.float32), ((0, pad_to - T), (0, 0)))
        return Vec3(a[:, 0].copy(), a[:, 1].copy(), a[:, 2].copy())

    valid = np.zeros(pad_to, bool)
    valid[:T] = True
    return MeshSource(
        A=v(mesh.A), B=v(mesh.B), C=v(mesh.C),
        na=v(mesh.na), nb=v(mesh.nb), nc=v(mesh.nc),
        valid=jnp.asarray(valid),
    )

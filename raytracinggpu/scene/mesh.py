"""Triangle mesh assembly: OBJ -> transforms -> BVH -> device tables.

Replaces TriangleMeshHost (global_launcher.cu:367-707): the host loads the
OBJ, applies ``rescale`` (global_launcher.cu:371-375) and optional rotation
(the reference's dead-but-intended ``transform`` kernel,
global_launcher.cu:340-365), builds the BVH, and emits *pre-dereferenced*
leaf-ordered SoA triangle tables — vertices are gathered into (A, B, C) per
triangle once on host so device intersection needs no index indirection at
all (the leaf ranges are contiguous thanks to the in-place BVH partition,
optimized.cu:494-499).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from raytracinggpu.accel.bvh import FlatBVH, build_bvh
from raytracinggpu.scene.obj import ObjMesh, read_obj


def rescale(vertices: np.ndarray, scale: float, offset) -> np.ndarray:
    """v -> v*scale + offset (global_launcher.cu:371-375)."""
    return (vertices * np.float32(scale) + np.asarray(offset, np.float32)).astype(
        np.float32
    )


def rotate_y(vertices: np.ndarray, angle: float) -> np.ndarray:
    """Y-axis rotation, the matrix the reference builds for the mesh pose
    (global_launcher.cu:990-994; realtime_render.cu:1311-1335)."""
    c, s = np.cos(angle, dtype=np.float32), np.sin(angle, dtype=np.float32)
    m = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    return (vertices @ m.T).astype(np.float32)


@dataclass
class MeshData:
    """Host-side mesh in BVH (leaf) triangle order."""

    A: np.ndarray  # (T, 3) first corner, BVH order
    B: np.ndarray
    C: np.ndarray
    na: np.ndarray  # (T, 3) per-corner vertex normals (zeros when absent)
    nb: np.ndarray
    nc: np.ndarray
    bvh: FlatBVH
    n_vertices: int
    n_normals: int

    @property
    def n_tri(self) -> int:
        return self.A.shape[0]


def build_mesh(
    obj: ObjMesh,
    builder: str = "reference",
) -> MeshData:
    """Dereference indices, build the BVH over the triangle soup, and reorder
    the per-triangle tables into BVH leaf order.

    builder: "reference" (midpoint-split, exact reference semantics) or
    "lbvh" (Morton-code linear BVH, accel/lbvh.py) — both emit the same flat
    layout, so every traversal mode works with either.
    """
    V = obj.vertices
    A = V[obj.vtx[:, 0]]
    B = V[obj.vtx[:, 1]]
    C = V[obj.vtx[:, 2]]

    if builder == "lbvh":
        from raytracinggpu.accel.lbvh import build_lbvh

        bvh = build_lbvh(A, B, C)
    else:
        bvh = build_bvh(A, B, C)
    o = bvh.order

    has_n = obj.normals.shape[0] > 0 and (obj.nrm >= 0).all()
    if has_n:
        na = obj.normals[obj.nrm[:, 0]]
        nb = obj.normals[obj.nrm[:, 1]]
        nc = obj.normals[obj.nrm[:, 2]]
    else:
        na = nb = nc = np.zeros_like(A)

    return MeshData(
        A=A[o].copy(),
        B=B[o].copy(),
        C=C[o].copy(),
        na=na[o].copy(),
        nb=nb[o].copy(),
        nc=nc[o].copy(),
        bvh=bvh,
        n_vertices=V.shape[0],
        n_normals=obj.normals.shape[0],
    )


def load_cat_mesh(
    path: str,
    embed_transform: bool,
    scale: float | None,
    offset,
    builder: str = "reference",
) -> MeshData:
    """Load + transform the cat mesh per launcher config (SURVEY.md §2.7):
    cpu: embed only; global/optimized: embed + rescale(0.6, (0,-4,0));
    array_bvh/realtime: rescale(0.6, (0,-10,0)) only."""
    obj = read_obj(path, embed_transform=embed_transform)
    if scale is not None:
        obj.vertices = rescale(obj.vertices, scale, offset)
    return build_mesh(obj, builder=builder)

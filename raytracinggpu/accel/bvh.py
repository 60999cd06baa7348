"""Host BVH builder emitting flat SoA node arrays.

Re-implements the reference's recursive median-of-space build
(``TriangleMesh::buildBVH``, cpu_launcher.cpp:190-224 / optimized.cu:476-510)
with identical semantics:

- node bbox over all three vertices of every triangle in [start, end)
  (compute_bbox, cpu_launcher.cpp:180-188),
- split axis = longest bbox extent with the reference's >=-priority tie-break,
- split plane at the bbox midpoint of that axis,
- in-place swap partition of the triangle index array by centroid
  ((A+B+C)/3, optimized.cu:494-499) — this keeps every node's triangle range
  *contiguous*, so a leaf is one range of the triangle tables,
- leaf when the partition degenerates (pivot <= start or pivot >= end-1) or
  fewer than 5 triangles remain (optimized.cu:503).

Flattening mirrors ``bvhTreeToArray`` (optimized.cu:512-534): preorder
emission, 10 fields per node [left, right, mn.xyz, mx.xyz, tri_start,
tri_end] with right == -1 marking a leaf.  On top of the reference layout we
derive two views:

- SoA int/float arrays (one array per field) for vectorized traversal,
- preorder *skip links* enabling stackless lockstep traversal: visiting nodes
  in preorder, a ray that rejects a node's AABB jumps to ``skip[node]`` (the
  node's preorder successor outside its subtree).  This replaces the per-thread
  ``int s[30]`` stack (optimized.cu:246) with branch-free control flow all
  lanes can execute in lockstep.
"""
from __future__ import annotations

import sys
from dataclasses import dataclass

import numpy as np

LEAF_MIN_TRIS = 5  # reference: triangle_end - triangle_start < 5 (optimized.cu:503)
NODE_FLOATS = 10   # reference flat record width (optimized.cu:512-534)


@dataclass
class FlatBVH:
    """Flat preorder BVH (host numpy).

    left/right: child node indices, -1 for leaves (right == -1 marks a leaf,
        matching the reference decode macro BUILD_BVH, optimized.cu:225-240).
    mn/mx: (N, 3) AABB corners.
    tri_start/tri_end: triangle range in the *reordered* triangle array.
    order: (T,) permutation mapping new triangle position -> original index.
    skip: (N,) preorder escape link (N == len when the subtree is last).
    """

    left: np.ndarray
    right: np.ndarray
    mn: np.ndarray
    mx: np.ndarray
    tri_start: np.ndarray
    tri_end: np.ndarray
    order: np.ndarray
    skip: np.ndarray

    @property
    def n_nodes(self) -> int:
        return len(self.left)

    def to_reference_layout(self) -> np.ndarray:
        """The exact 10-float-per-node array of bvhTreeToArray
        (optimized.cu:512-534): [left, right, mn.xyz, mx.xyz, start, end]."""
        out = np.zeros((self.n_nodes, NODE_FLOATS), np.float32)
        out[:, 0] = self.left
        out[:, 1] = self.right
        out[:, 2:5] = self.mn
        out[:, 5:8] = self.mx
        out[:, 8] = self.tri_start
        out[:, 9] = self.tri_end
        return out.reshape(-1)


def build_bvh(
    A: np.ndarray, B: np.ndarray, C: np.ndarray, native: bool | None = None
) -> FlatBVH:
    """Build from triangle vertex arrays (T, 3); returns the flat preorder BVH.

    The recursion and the swap-based partition replicate the reference
    exactly (including its non-stable partition order), so the resulting
    triangle ordering and tree shape match what the CUDA code would build.

    native: use the C++ builder (identical algorithm/fp semantics; tested
    bit-equal) when available.
    """
    if native is not False:
        from raytracinggpu import native as native_mod

        built = native_mod.build_bvh(A, B, C)
        if built is not None:
            left, right, start, end, skip, mn, mx, order = built
            return FlatBVH(
                left=left, right=right, mn=mn, mx=mx,
                tri_start=start, tri_end=end, order=order.astype(np.int64),
                skip=skip,
            )
        if native is True:
            raise RuntimeError("native library requested but unavailable")
    A = np.asarray(A, np.float32)
    B = np.asarray(B, np.float32)
    C = np.asarray(C, np.float32)
    T = A.shape[0]
    order = np.arange(T)
    cen = (A + B + C) / 3.0  # float32 centroid, matching optimized.cu:496

    left, right, mns, mxs, starts, ends = [], [], [], [], [], []

    sys.setrecursionlimit(10000)

    def emit() -> int:
        idx = len(left)
        for lst in (left, right, starts, ends):
            lst.append(-1)
        mns.append(None)
        mxs.append(None)
        return idx

    def build(node: int, s: int, e: int) -> None:
        ids = order[s:e]
        pts = np.concatenate([A[ids], B[ids], C[ids]], axis=0)
        mn = pts.min(axis=0)
        mx = pts.max(axis=0)
        starts[node], ends[node] = s, e
        mns[node], mxs[node] = mn, mx

        d = mx - mn
        # Reference tie-break (optimized.cu:484-491): x wins >=, then y.
        if d[0] >= d[1] and d[0] >= d[2]:
            axis = 0
        elif d[1] >= d[0] and d[1] >= d[2]:
            axis = 1
        else:
            axis = 2
        split = (mn[axis] + mx[axis]) / 2.0

        # In-place swap partition over the order array (optimized.cu:494-499).
        # Positions j > i are never written before the loop visits them
        # (swaps only touch positions <= i), so the original per-position
        # `less` flags are exactly what the reference compares.  The swap
        # sequence is replicated verbatim: it front-loads the `<` side stably
        # and leaves the `>=` side in the reference's (non-stable) order,
        # which determines descendant splits and the final triangle layout.
        seg = order[s:e]
        less = cen[seg, axis] < split
        n_less = int(less.sum())
        if 0 < n_less < len(seg):
            tmp = seg.copy()
            p = 0
            for i in range(len(tmp)):
                if less[i]:
                    tmp[i], tmp[p] = tmp[p], tmp[i]
                    p += 1
            order[s:e] = tmp
        pivot = s + n_less

        if pivot <= s or pivot >= e - 1 or e - s < LEAF_MIN_TRIS:
            return
        li = emit()
        left[node] = li
        build(li, s, pivot)
        ri = emit()
        right[node] = ri
        build(ri, pivot, e)

    root = emit()
    build(root, 0, T)

    n = len(left)
    flat = FlatBVH(
        left=np.asarray(left, np.int32),
        right=np.asarray(right, np.int32),
        mn=np.stack(mns).astype(np.float32),
        mx=np.stack(mxs).astype(np.float32),
        tri_start=np.asarray(starts, np.int32),
        tri_end=np.asarray(ends, np.int32),
        order=order,
        skip=np.zeros(n, np.int32),
    )
    _compute_skip_links(flat)
    return flat


def _compute_skip_links(bvh: FlatBVH) -> None:
    """skip[i] = preorder index of the first node after i's subtree.
    Iterative (explicit stack): deep skewed trees would exceed Python's
    recursion limit on the native-build path."""
    n = bvh.n_nodes

    stack = [(0, n)]
    while stack:
        node, escape = stack.pop()
        bvh.skip[node] = escape
        l, r = bvh.left[node], bvh.right[node]
        if r != -1:
            stack.append((r, escape))  # right child escapes like the parent
            stack.append((l, r))       # left child escapes to right sibling


def check_invariants(bvh: FlatBVH, A, B, C) -> None:
    """Structural invariants (the reference has no such checks; SURVEY.md §4
    calls for them): raises AssertionError on violation."""
    n = bvh.n_nodes
    T = len(bvh.order)
    assert sorted(bvh.order.tolist()) == list(range(T)), "order not a permutation"
    is_leaf = bvh.right == -1
    assert is_leaf[0] or (bvh.left[0] == 1), "preorder: left child follows parent"
    # Each internal node's children partition its range; child boxes within parent.
    for i in range(n):
        s, e = bvh.tri_start[i], bvh.tri_end[i]
        assert s < e
        if not is_leaf[i]:
            l, r = bvh.left[i], bvh.right[i]
            assert bvh.tri_start[l] == s and bvh.tri_end[r] == e
            assert bvh.tri_end[l] == bvh.tri_start[r]
            assert (bvh.mn[l] >= bvh.mn[i] - 1e-5).all() and (bvh.mx[l] <= bvh.mx[i] + 1e-5).all()
            assert (bvh.mn[r] >= bvh.mn[i] - 1e-5).all() and (bvh.mx[r] <= bvh.mx[i] + 1e-5).all()
        # bbox actually contains its triangles
        ids = bvh.order[s:e]
        pts = np.concatenate([A[ids], B[ids], C[ids]])
        assert (pts.min(0) >= bvh.mn[i] - 1e-4).all() and (pts.max(0) <= bvh.mx[i] + 1e-4).all()
    # Leaf ranges partition [0, T)
    leaf_ranges = sorted(
        (bvh.tri_start[i], bvh.tri_end[i]) for i in range(n) if is_leaf[i]
    )
    pos = 0
    for s, e in leaf_ranges:
        assert s == pos, f"leaf gap at {pos}"
        pos = e
    assert pos == T
    # Skip links: in-preorder escape must be > node, <= n
    assert ((bvh.skip > np.arange(n)) & (bvh.skip <= n)).all()


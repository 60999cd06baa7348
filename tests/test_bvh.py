"""BVH builder: structural invariants, reference flat layout, skip links
(SURVEY.md §4's required checks — the reference has none)."""
import numpy as np
import pytest

from raytracinggpu.accel.bvh import (
    LEAF_MIN_TRIS,
    build_bvh,
    check_invariants,
)


def _random_tris(rng, n=200, spread=10.0):
    A = (rng.random((n, 3)) * spread).astype(np.float32)
    B = A + rng.standard_normal((n, 3)).astype(np.float32)
    C = A + rng.standard_normal((n, 3)).astype(np.float32)
    return A, B, C


def test_invariants_random(rng):
    A, B, C = _random_tris(rng)
    bvh = build_bvh(A, B, C)
    check_invariants(bvh, A, B, C)


def test_invariants_cat(cat_mesh_raw):
    obj = cat_mesh_raw
    A = obj.vertices[obj.vtx[:, 0]]
    B = obj.vertices[obj.vtx[:, 1]]
    C = obj.vertices[obj.vtx[:, 2]]
    bvh = build_bvh(A, B, C)
    check_invariants(bvh, A, B, C)
    # The cat splits deeply: expect hundreds of nodes, leaves mostly < 2*min.
    assert bvh.n_nodes > 500
    leaves = bvh.right == -1
    sizes = (bvh.tri_end - bvh.tri_start)[leaves]
    assert sizes.min() >= 1


def test_leaf_threshold():
    # Fewer than LEAF_MIN_TRIS triangles -> single leaf node
    # (optimized.cu:503: triangle_end - triangle_start < 5).
    rng = np.random.default_rng(0)
    A, B, C = _random_tris(rng, n=LEAF_MIN_TRIS - 1)
    bvh = build_bvh(A, B, C)
    assert bvh.n_nodes == 1 and bvh.right[0] == -1


def test_reference_flat_layout():
    """to_reference_layout emits the 10-float-per-node records of
    bvhTreeToArray (optimized.cu:512-534)."""
    rng = np.random.default_rng(1)
    A, B, C = _random_tris(rng, n=64)
    bvh = build_bvh(A, B, C)
    flat = bvh.to_reference_layout().reshape(-1, 10)
    assert flat.shape[0] == bvh.n_nodes
    for i in range(bvh.n_nodes):
        assert flat[i, 0] == bvh.left[i] and flat[i, 1] == bvh.right[i]
        np.testing.assert_array_equal(flat[i, 2:5], bvh.mn[i])
        np.testing.assert_array_equal(flat[i, 5:8], bvh.mx[i])
        assert flat[i, 8] == bvh.tri_start[i] and flat[i, 9] == bvh.tri_end[i]


def test_skip_links_preorder(rng):
    A, B, C = _random_tris(rng, n=128)
    bvh = build_bvh(A, B, C)
    n = bvh.n_nodes
    # Walking with skip links visits every node exactly once in preorder.
    visited = []
    node = 0
    while node < n:
        visited.append(node)
        node += 1  # "descend" (preorder successor)
    assert visited == list(range(n))
    # skip[i] must equal the preorder index after i's subtree: verify by
    # recomputing subtree extents.
    def subtree_end(i):
        if bvh.right[i] == -1:
            return i + 1
        return subtree_end(bvh.right[i])
    for i in range(n):
        assert bvh.skip[i] == subtree_end(i)


@pytest.mark.parametrize("n", [5, 6, 17])
def test_small_meshes(n, rng):
    A, B, C = _random_tris(rng, n=n)
    bvh = build_bvh(A, B, C)
    check_invariants(bvh, A, B, C)

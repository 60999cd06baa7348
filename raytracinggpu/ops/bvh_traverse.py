"""Stackless flat-BVH traversal in plain XLA (lockstep, gather-based).

A kernel-free reference for the reference's flat-array traversal
(optimized.cu:220-285: per-thread ``int s[30]`` stack over 10-float node
records), in the *preorder skip-link* form of the same flat tree
(accel/bvh.py): every ray walks nodes in preorder; on an AABB reject it
jumps to ``skip[node]`` (the preorder successor outside the subtree), on
accept it advances to ``node+1`` (its first child, or the leaf test).
All lanes advance in lockstep inside one ``lax.while_loop``; finished lanes
idle at node == n_nodes.  The walk kernel (ops/walk.py) runs the same walk
per lane.

Leaf triangle tests reuse the factorized Moller-Trumbore feature matrix
(ops/triangle.py) gathered per lane, statically unrolled to
``max_leaf_tris`` (RenderConfig.bvh_max_leaf).  Degenerate midpoint
partitions can produce leaves of any size; build_scene_tables warns when a
mesh's worst leaf exceeds the default bound.  The lbvh builder never
produces such leaves: it splits every range of >= 5 triangles (with a
median fallback for identical Morton codes), so its leaves hold < 5
triangles by construction (accel/lbvh.py).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from raytracinggpu.core.vec import Vec3
from raytracinggpu.ops.triangle import TriHit, TriTables, ray_features
from raytracinggpu.scene.scene import BVHTables

INF = 1e9 + 9
# Static unroll bound for leaf tests.  The reference split stops when < 5
# triangles remain OR the midpoint partition degenerates (optimized.cu:503)
# — degenerate partitions can leave large leaves (the cat's worst leaf holds
# 73 triangles), faithfully reproduced here.
MAX_LEAF_TRIS = 96


def intersect_tris_bvh(
    O: Vec3,
    u: Vec3,
    tab: TriTables,
    bvh: BVHTables,
    eps_leaf: float,
    max_leaf_tris: int = MAX_LEAF_TRIS,
    node_layout: str = "soa",
) -> TriHit:
    """Closest hit via lockstep skip-link traversal.

    Every iteration each live lane: gathers its node's AABB + topology,
    slab-tests (reference semantics, global_launcher.cu:172-183 — no
    behind-ray check, matching the GPU variants' unconditional pushes),
    and either descends (node+1) or skips the subtree.  Leaf lanes test
    up to MAX_LEAF_TRIS triangles via gathered MT features.

    node_layout: "soa" gathers each node field from its own column array
    (7 small gathers per step); "aos10" rebuilds the reference's 10-float
    record [left, right, mn.xyz, mx.xyz, start, end]
    (accel.bvh.FlatBVH.to_reference_layout, optimized.cu:512-534) and
    fetches one (R, 10) row-gather per step — the node-layout / gather-
    strategy ablation axis (SURVEY §2.11: the analog of the
    shared/texture memory-placement variants).  Both produce bit-identical
    hits; the skip link (this design's stackless addition) always rides a
    separate int column.
    """
    R = O.x.shape[0]
    n_nodes = bvh.left.shape[0]
    f = ray_features(O, u)  # (R, 10)
    rcp = Vec3(1.0 / u.x, 1.0 / u.y, 1.0 / u.z)

    if node_layout == "aos10":
        # index fields ride as float32 in the 10-float record: exact only
        # below 2^24 (this mode exists for the reference-layout ablation;
        # the SoA walk has no such bound)
        if max(n_nodes, tab.mt.shape[-1]) >= 1 << 24:
            raise ValueError(
                "node_layout='aos10' stores node/triangle indices as "
                "float32 (exact below 2^24); use node_layout='soa' for "
                "meshes this large")
        nodes10 = jnp.stack(
            [bvh.left.astype(jnp.float32), bvh.right.astype(jnp.float32),
             bvh.mn.x, bvh.mn.y, bvh.mn.z, bvh.mx.x, bvh.mx.y, bvh.mx.z,
             bvh.tri_start.astype(jnp.float32),
             bvh.tri_end.astype(jnp.float32)], axis=1)  # (n_nodes, 10)
    elif node_layout != "soa":
        raise ValueError(f"unknown node_layout {node_layout!r}")

    def fetch(nd):
        """Per-lane node record -> (mn, mx, is_leaf, start, end)."""
        if node_layout == "aos10":
            rows = nodes10[nd]                       # one (R, 10) gather
            mn = Vec3(rows[:, 2], rows[:, 3], rows[:, 4])
            mx = Vec3(rows[:, 5], rows[:, 6], rows[:, 7])
            is_leaf = rows[:, 1] == -1.0
            start = rows[:, 8].astype(jnp.int32)
            end = rows[:, 9].astype(jnp.int32)
        else:
            mn = Vec3(bvh.mn.x[nd], bvh.mn.y[nd], bvh.mn.z[nd])
            mx = Vec3(bvh.mx.x[nd], bvh.mx.y[nd], bvh.mx.z[nd])
            is_leaf = bvh.right[nd] == -1
            start = bvh.tri_start[nd]
            end = bvh.tri_end[nd]
        return mn, mx, is_leaf, start, end

    mt = tab.mt  # (10, 4, Tp)

    def leaf_test(start, end, t_best, i_best, b_best, g_best):
        for k in range(max_leaf_tris):
            ti = start + k
            live = ti < end
            ti = jnp.minimum(ti, mt.shape[-1] - 1)
            cols = mt[:, :, ti]                      # (10, 4, R)
            out = jnp.einsum("rk,kcr->cr", f, cols,
                             precision=jax.lax.Precision.HIGHEST)  # (4, R)
            denom, bn, gn, tn = out[0], out[1], out[2], out[3]
            beta = bn / denom
            gamma = gn / denom
            tval = tn / denom
            valid = (
                live
                & (denom != 0.0)
                & (beta >= 0.0) & (beta <= 1.0)
                & (gamma >= 0.0) & (gamma <= 1.0)
                & (beta + gamma <= 1.0)
                & (tval > 0.0) & (tval > eps_leaf)
            )
            better = valid & (tval < t_best)
            t_best = jnp.where(better, tval, t_best)
            i_best = jnp.where(better, ti.astype(jnp.int32), i_best)
            b_best = jnp.where(better, beta, b_best)
            g_best = jnp.where(better, gamma, g_best)
        return t_best, i_best, b_best, g_best

    def slab_hit(mn, mx):
        t0 = Vec3((mn.x - O.x) * rcp.x, (mn.y - O.y) * rcp.y, (mn.z - O.z) * rcp.z)
        t1 = Vec3((mx.x - O.x) * rcp.x, (mx.y - O.y) * rcp.y, (mx.z - O.z) * rcp.z)
        enter = jnp.maximum(
            jnp.minimum(t0.x, t1.x),
            jnp.maximum(jnp.minimum(t0.y, t1.y), jnp.minimum(t0.z, t1.z)),
        )
        exit_ = jnp.minimum(
            jnp.maximum(t0.x, t1.x),
            jnp.minimum(jnp.maximum(t0.y, t1.y), jnp.maximum(t0.z, t1.z)),
        )
        # Reference slab test: min(t1s) > max(t0s) — no behind-ray culling
        # (global_launcher.cu:182).
        return exit_ > enter

    def cond(state):
        node, *_ = state
        return jnp.any(node < n_nodes)

    def body(state):
        node, t_best, i_best, b_best, g_best = state
        live = node < n_nodes
        nd = jnp.minimum(node, n_nodes - 1)
        mn, mx, is_leaf, start, end = fetch(nd)
        hit = slab_hit(mn, mx) & live
        do_leaf = hit & is_leaf
        tb, ib, bb, gb = leaf_test(
            jnp.where(do_leaf, start, 0), jnp.where(do_leaf, end, 0),
            t_best, i_best, b_best, g_best
        )
        # Lanes not at a live leaf keep their previous winners.
        t_best = jnp.where(do_leaf, tb, t_best)
        i_best = jnp.where(do_leaf, ib, i_best)
        b_best = jnp.where(do_leaf, bb, b_best)
        g_best = jnp.where(do_leaf, gb, g_best)
        # Advance: descend into accepted internal nodes, otherwise skip.
        nxt = jnp.where(hit & ~is_leaf, nd + 1, bvh.skip[nd])
        node = jnp.where(live, nxt, node)
        return node, t_best, i_best, b_best, g_best

    init = (
        jnp.zeros((R,), jnp.int32),
        jnp.full((R,), INF, jnp.float32),
        jnp.zeros((R,), jnp.int32),
        jnp.zeros((R,), jnp.float32),
        jnp.zeros((R,), jnp.float32),
    )
    node, t, idx, beta, gamma = jax.lax.while_loop(cond, body, init)
    return TriHit(t=t, idx=idx, beta=beta, gamma=gamma)

"""Per-ray stackless BVH walk: a Pallas kernel on the Triton route.

The reference renders with one CUDA thread per pixel; each thread walks a
flat BVH of 10-float node records with a private ``int s[30]`` stack and
tests every triangle of each leaf it reaches with Moller-Trumbore
(optimized.cu:220-285, array_bvh.cu:231-307).  This kernel keeps that
design: one ray per lane, data-dependent per-lane loads of node and
triangle records (they stay in L1/L2: the cat's tables are about 1 MB).

- **Stackless.** The walk follows the preorder skip links that
  ``accel/bvh.py`` emits: on a box hit an internal node advances to
  ``node + 1`` (its left child), a leaf tests its triangles, and a miss
  jumps to ``skip[node]``.  That visits nodes in the order of the
  reference GPU variants' unconditional pushes, with no per-lane stack.
- **Leaves.** A leaf's triangles are tested in an inner loop that runs
  while any lane of the block still has triangles left in its leaf; the
  midpoint builder leaves leaves of any size (73 triangles on the cat).
- **Arithmetic.** Each triangle is the same factorized Moller-Trumbore
  form as ``ops/triangle._block_mt``: the ray features ``[u, O x u, O, 1]``
  dotted with the nonzero coefficients of the triangle's ``(10, 4)``
  matrix, summed in the same order, then divided by the denominator.
- **Variants.** The closest-hit walk returns ``TriHit(t, idx, beta,
  gamma)``, lowest triangle index winning exact ties (leaves are visited
  in ascending triangle order and only a strictly smaller ``t`` replaces
  the winner).  The shadow walk is any-hit: a lane stops at the first hit
  with ``t * t <= cap2``, which leaves the integrator's occlusion
  predicate ``t * t <= |L - P|^2`` unchanged.

On a GPU the kernel is compiled through Triton; on the CPU it runs in the
Pallas interpreter, which is how the test suite runs it.  ``_interpret``
is the one place that decides, and any other platform is an error.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from raytracinggpu.core.vec import Vec3
from raytracinggpu.ops.triangle import INF, TriHit, TriTables

# Floats per node record: [mn.xyz, mx.xyz, pad, pad] (32-byte rows).
NODE_F = 8
# Ints per node link record: [skip, tri_start, leaf_tris, pad]; leaf_tris
# is 0 for an internal node.
NODE_I = 4
# Floats per triangle record: the nonzero Moller-Trumbore coefficients
# (ops/triangle.build_tri_tables) in feature order -- 0-2 denom (Ng),
# 3-8 beta (e2 x A, -e2), 9-14 gamma (-(e1 x A), e1), 15 A.Ng; the t
# numerator's O coefficients are -Ng, negated in-kernel.
TRI_F = 16
# Ray rows handed to the kernel: u, w = O x u, O, 1/u, cap2, pad.
RAY_ROWS = 16
BLOCKS = (32, 64, 128)
DEF_BLOCK = 32


class WalkTables(NamedTuple):
    """Flat device tables of the walk (1-D, row-major records)."""

    nodes: jnp.ndarray  # (n_nodes * NODE_F,) f32
    links: jnp.ndarray  # (n_nodes * NODE_I,) i32
    tris: jnp.ndarray   # (Tp * TRI_F,) f32


def build_walk_tables(mesh: TriTables, bvh) -> WalkTables:
    """Derive the walk's tables from the MT matrix and the flat BVH
    (``scene.scene.BVHTables``).  Pure jnp, so ``scene/transform.pose_mesh``
    rebuilds them in-jit from a posed mesh."""
    mt = mesh.mt
    tris = jnp.concatenate(
        [mt[0:3, 0], mt[0:6, 1], mt[0:6, 2], mt[9:10, 3]], axis=0).T
    zf = jnp.zeros_like(bvh.mn.x)
    nodes = jnp.stack(
        [bvh.mn.x, bvh.mn.y, bvh.mn.z, bvh.mx.x, bvh.mx.y, bvh.mx.z, zf, zf],
        axis=1)
    leaf_tris = jnp.where(bvh.right == -1, bvh.tri_end - bvh.tri_start, 0)
    links = jnp.stack(
        [bvh.skip, bvh.tri_start, leaf_tris, jnp.zeros_like(bvh.skip)],
        axis=1)
    return WalkTables(nodes=nodes.reshape(-1).astype(jnp.float32),
                      links=links.reshape(-1).astype(jnp.int32),
                      tris=tris.reshape(-1).astype(jnp.float32))


def _interpret() -> bool:
    """Compiled on a GPU, interpreted on the CPU (the test suite), and
    refused elsewhere: the kernel never runs interpreted on an
    accelerator."""
    platform = jax.default_backend()
    if platform == "gpu":
        return False
    if platform == "cpu":
        return True
    raise RuntimeError(
        f"the BVH walk kernel runs on a GPU (or interpreted on the CPU), "
        f"not on {platform!r}; use traversal='dense' or 'bvh'")


def _walk_kernel(rays_ref, node0_ref, nodes_ref, links_ref, tris_ref,
                 *out_refs, n_nodes: int, eps_leaf: float, any_hit: bool):
    row = lambda k: rays_ref[k, :]
    ux, uy, uz = row(0), row(1), row(2)
    wx, wy, wz = row(3), row(4), row(5)
    ox, oy, oz = row(6), row(7), row(8)
    rx, ry, rz = row(9), row(10), row(11)
    cap2 = row(12)
    node = node0_ref[...]
    B = node.shape[0]
    zf = jnp.zeros((B,), jnp.float32)
    zi = jnp.zeros((B,), jnp.int32)
    eps = np.float32(eps_leaf)

    def any_lane(mask):
        # Triton lowers no reduce_or: a max over int32 is the block vote.
        return jnp.max(mask.astype(jnp.int32)) > 0

    def tri_test(tri, end, best):
        t_best = best[0]
        live = tri < end
        base = jnp.where(live, tri, 0) * TRI_F
        g = lambda k: tris_ref[base + k]
        n0, n1, n2 = g(0), g(1), g(2)
        denom = ux * n0 + uy * n1 + uz * n2
        bn = ux * g(3) + uy * g(4) + uz * g(5) + wx * g(6) + wy * g(7) \
            + wz * g(8)
        gn = ux * g(9) + uy * g(10) + uz * g(11) + wx * g(12) \
            + wy * g(13) + wz * g(14)
        tn = ox * -n0 + oy * -n1 + oz * -n2 + g(15)
        beta = bn / denom
        gamma = gn / denom
        tval = tn / denom
        better = (
            live
            & (denom != 0.0)
            & (beta >= 0.0) & (beta <= 1.0)
            & (gamma >= 0.0) & (gamma <= 1.0)
            & (beta + gamma <= 1.0)
            & (tval > 0.0) & (tval > eps)
            & (tval < t_best)
        )
        t_best = jnp.where(better, tval, t_best)
        if any_hit:
            return (t_best,)
        _, i_best, b_best, g_best = best
        return (t_best, jnp.where(better, tri, i_best),
                jnp.where(better, beta, b_best),
                jnp.where(better, gamma, g_best))

    def leaf_cond(c):
        tri, end = c[0], c[1]
        return any_lane(tri < end)

    def leaf_body(c):
        tri, end, *best = c
        best = tri_test(tri, end, best)
        if any_hit:
            # a hit inside the cap ends the lane's walk
            end = jnp.where(best[0] * best[0] <= cap2, tri, end)
        return (tri + 1, end, *best)

    def walk_cond(c):
        return any_lane(c[0] < n_nodes)

    def walk_body(c):
        node, *best = c
        live = node < n_nodes
        nd = jnp.minimum(node, n_nodes - 1)
        fb = nd * NODE_F
        ib = nd * NODE_I
        f = lambda k: nodes_ref[fb + k]
        t0x = (f(0) - ox) * rx
        t0y = (f(1) - oy) * ry
        t0z = (f(2) - oz) * rz
        t1x = (f(3) - ox) * rx
        t1y = (f(4) - oy) * ry
        t1z = (f(5) - oz) * rz
        enter = jnp.maximum(jnp.minimum(t0x, t1x), jnp.maximum(
            jnp.minimum(t0y, t1y), jnp.minimum(t0z, t1z)))
        exit_ = jnp.minimum(jnp.maximum(t0x, t1x), jnp.minimum(
            jnp.maximum(t0y, t1y), jnp.maximum(t0z, t1z)))
        # The reference's slab test (global_launcher.cu:172-183): no
        # behind-ray rejection.  It accepts on exit > enter; a box that is
        # flat along an axis (a leaf of coplanar axis-aligned triangles)
        # has exit == enter for every ray that crosses it, so the walk
        # accepts equality too, or it would lose those hits.
        hit = live & (exit_ >= enter)
        skip = links_ref[ib]
        start = links_ref[ib + 1]
        n_leaf = links_ref[ib + 2]
        is_leaf = n_leaf > 0
        do_leaf = hit & is_leaf
        tri = jnp.where(do_leaf, start, 0)
        end = jnp.where(do_leaf, start + n_leaf, 0)
        _, _, *best = jax.lax.while_loop(
            leaf_cond, leaf_body, (tri, end, *best))
        nxt = jnp.where(hit & ~is_leaf, nd + 1, skip)
        if any_hit:
            nxt = jnp.where(best[0] * best[0] <= cap2, n_nodes, nxt)
        return (jnp.where(live, nxt, node), *best)

    init = (zf + np.float32(INF),)
    if not any_hit:
        init = init + (zi, zf, zf)
    _, *best = jax.lax.while_loop(walk_cond, walk_body, (node, *init))
    for ref, val in zip(out_refs, best):
        ref[...] = val


def _ray_rows(O: Vec3, u: Vec3, cap2, Rp: int):
    """(RAY_ROWS, Rp) ray feature rows; padding lanes get a zero ray."""
    w = O.cross(u)
    rows = [u.x, u.y, u.z, w.x, w.y, w.z, O.x, O.y, O.z,
            1.0 / u.x, 1.0 / u.y, 1.0 / u.z, cap2]
    R = O.x.shape[0]
    rays = jnp.stack([jnp.broadcast_to(r, (R,)).astype(jnp.float32)
                      for r in rows])
    return jnp.pad(rays, ((0, RAY_ROWS - len(rows)), (0, Rp - R)))


@functools.partial(jax.jit, static_argnames=(
    "eps_leaf", "any_hit", "block", "interpret"))
def _walk_call(rays, node0, tab: WalkTables, *, eps_leaf: float,
               any_hit: bool, block: int, interpret: bool):
    Rp = rays.shape[1]
    n_nodes = tab.links.shape[0] // NODE_I
    kernel = functools.partial(_walk_kernel, n_nodes=n_nodes,
                               eps_leaf=float(eps_leaf), any_hit=any_hit)
    whole = pl.BlockSpec(memory_space=None)
    lanes = pl.BlockSpec((block,), lambda i: (i,))
    f32 = jax.ShapeDtypeStruct((Rp,), jnp.float32)
    i32 = jax.ShapeDtypeStruct((Rp,), jnp.int32)
    out_shape = (f32,) if any_hit else (f32, i32, f32, f32)
    return pl.pallas_call(
        kernel,
        out_shape=out_shape,
        grid=(Rp // block,),
        in_specs=[pl.BlockSpec((RAY_ROWS, block), lambda i: (0, i)), lanes,
                  whole, whole, whole],
        out_specs=tuple(lanes for _ in out_shape),
        compiler_params=plgpu.CompilerParams(
            num_warps=max(1, block // 32), num_stages=1),
        interpret=interpret,
        name="bvh_walk_shadow" if any_hit else "bvh_walk_closest",
    )(rays, node0, tab.nodes, tab.links, tab.tris)


def _walk(O: Vec3, u: Vec3, tab: WalkTables, eps_leaf: float, cap2,
          active, block: int, any_hit: bool):
    """Pad the rays to whole blocks and run the walk; lanes that are
    inactive or padding start at node n_nodes, so they never walk."""
    if block not in BLOCKS:
        raise ValueError(f"walk block must be one of {BLOCKS}, got {block}")
    R = O.x.shape[0]
    Rp = -(-R // block) * block
    n_nodes = tab.links.shape[0] // NODE_I
    node0 = (jnp.zeros((R,), jnp.int32) if active is None
             else jnp.where(active, 0, n_nodes).astype(jnp.int32))
    node0 = jnp.pad(node0, (0, Rp - R), constant_values=n_nodes)
    outs = _walk_call(
        _ray_rows(O, u, cap2, Rp), node0, tab, eps_leaf=float(eps_leaf),
        any_hit=any_hit, block=block, interpret=_interpret())
    return [o[:R] for o in outs]


def intersect_tris_walk(O: Vec3, u: Vec3, tab: WalkTables, eps_leaf: float,
                        block: int = DEF_BLOCK) -> TriHit:
    """Closest hit of every ray against the mesh (same result contract as
    ``ops/triangle.intersect_tris_dense``)."""
    return TriHit(*_walk(O, u, tab, eps_leaf, 0.0, None, block, False))


def intersect_tris_walk_shadow(O: Vec3, u: Vec3, tab: WalkTables,
                               eps_leaf: float, cap2, active=None,
                               block: int = DEF_BLOCK):
    """Any-hit shadow walk.  Returns per-ray t: a hit with ``t*t <= cap2``
    where one exists, else the nearest hit (``INF`` on a miss).  Lanes
    with ``active`` False skip the walk and return ``INF``."""
    return _walk(O, u, tab, eps_leaf, cap2, active, block, True)[0]

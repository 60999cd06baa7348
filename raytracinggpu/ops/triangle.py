"""Ray-triangle intersection as a matrix product.

The reference tests triangles one at a time inside a divergent CUDA loop with
``moller_trumbore`` (global_launcher.cu:233-243):

    e1 = B-A; e2 = C-A; N = e1 x e2
    denom = u.N                       (reject 0)
    beta  =  e2.((A-O) x u) / denom   (reject outside [0,1])
    gamma = -e1.((A-O) x u) / denom   (reject outside [0,1])
    t     = (A-O).N / denom           (accept beta+gamma<=1 and t>0)

The same algebra factorizes into a *matrix product*: every determinant above is
bilinear in (per-ray, per-triangle) quantities.  Using the scalar triple
product identities

    e2.((A-O) x u) = u.(e2 x A) - e2.(O x u)
    e1.((A-O) x u) = u.(e1 x A) - e1.(O x u)
    (A-O).N        = A.N - O.N

all four quantities (denom, beta*denom, gamma*denom, t*denom) are inner
products of a 10-feature ray vector

    f(ray) = [u, w = O x u, O, 1]            (shape (R, 10))

with a per-triangle constant matrix (shape (10, 4, T)).  One
(R,10)x(10,4T) product computes Moller-Trumbore for all (ray, triangle)
pairs, and a running min over triangle blocks (flash-attention style scan)
keeps memory at O(R * block) instead of O(R * T).  Every contraction asks
for ``Precision.HIGHEST``: a float32 product may otherwise run in TF32 on a
GPU, which keeps about three decimal digits.

Triangle tables are built on host in float32 numpy from the BVH-reordered
triangle soup, so leaf/cluster ranges stay contiguous (the property produced
by the in-place partition in TriangleMesh::buildBVH, optimized.cu:476-510).
The same coefficients, stored per triangle, drive the BVH walk kernel
(ops/walk.py).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from raytracinggpu.core.vec import Vec3

INF = 1e9 + 9

# Feature count of the ray vector [u(3), O x u(3), O(3), 1].
NUM_RAY_FEATURES = 10
# Outputs per triangle: denom, beta_num, gamma_num, t_num.
NUM_TRI_OUTPUTS = 4


class TriTables(NamedTuple):
    """Precomputed per-triangle intersection tables (device arrays).

    mt: (10, 4, Tp) float32 — the Moller-Trumbore feature matrix.
    ng: Vec3 of (Tp,) — geometric normal e1 x e2 (unnormalized).
    na, nb, nc: Vec3 of (Tp,) — per-corner vertex normals for Phong-smooth
        shading (realtime_render.cu:221-245); zeros when absent.
    n_tri: true (unpadded) triangle count.
    """

    mt: jnp.ndarray
    ng: Vec3
    na: Vec3
    nb: Vec3
    nc: Vec3
    cornersT: jnp.ndarray  # (Tp, 16): [na, nb, nc, ng, pad] — winner-normal
                           # recovery gathers one row per ray instead of 12
                           # separate (R,)-scale gathers
    n_tri: int


def build_tri_tables(
    A: np.ndarray,
    B: np.ndarray,
    C: np.ndarray,
    na: np.ndarray | None = None,
    nb: np.ndarray | None = None,
    nc: np.ndarray | None = None,
    pad_to: int | None = None,
) -> TriTables:
    """Build the MT feature matrix from triangle vertices (T, 3) float arrays.

    Padded triangles are fully degenerate (all zeros): their geometric normal
    is zero so denom == 0 and they can never produce a valid hit.
    """
    A = np.asarray(A, np.float32)
    B = np.asarray(B, np.float32)
    C = np.asarray(C, np.float32)
    T = A.shape[0]
    Tp = pad_to if pad_to is not None else T
    assert Tp >= T

    def pad(v):
        return np.pad(v, ((0, Tp - T), (0, 0)))

    Ap, Bp, Cp = pad(A), pad(B), pad(C)
    e1 = Bp - Ap
    e2 = Cp - Ap
    ng = np.cross(e1, e2)

    m = np.zeros((NUM_RAY_FEATURES, NUM_TRI_OUTPUTS, Tp), np.float32)
    # denom = u . Ng
    m[0:3, 0, :] = ng.T
    # beta_num = u . (e2 x A) - w . e2
    m[0:3, 1, :] = np.cross(e2, Ap).T
    m[3:6, 1, :] = -e2.T
    # gamma_num = w . e1 - u . (e1 x A)
    m[0:3, 2, :] = -np.cross(e1, Ap).T
    m[3:6, 2, :] = e1.T
    # t_num = A . Ng - O . Ng
    m[6:9, 3, :] = -ng.T
    m[9, 3, :] = np.einsum("td,td->t", Ap, ng)

    def vec(v):
        if v is None:
            z = np.zeros(Tp, np.float32)
            return Vec3(z, z, z)
        v = np.pad(np.asarray(v, np.float32), ((0, Tp - T), (0, 0)))
        return Vec3(v[:, 0], v[:, 1], v[:, 2])

    def padn(v):
        if v is None:
            return np.zeros((Tp, 3), np.float32)
        return np.pad(np.asarray(v, np.float32), ((0, Tp - T), (0, 0)))

    corners = np.zeros((Tp, 16), np.float32)
    corners[:, 0:3] = padn(na)
    corners[:, 3:6] = padn(nb)
    corners[:, 6:9] = padn(nc)
    corners[:, 9:12] = ng

    return TriTables(
        mt=m,
        ng=Vec3(ng[:, 0].copy(), ng[:, 1].copy(), ng[:, 2].copy()),
        na=vec(na),
        nb=vec(nb),
        nc=vec(nc),
        cornersT=corners,
        n_tri=T,
    )


def ray_features(O: Vec3, u: Vec3) -> jnp.ndarray:
    """f(ray) = [u, O x u, O, 1], shape (R, 10)."""
    w = O.cross(u)
    one = jnp.ones_like(u.x)
    return jnp.stack(
        [u.x, u.y, u.z, w.x, w.y, w.z, O.x, O.y, O.z, one], axis=-1
    )


class TriHit(NamedTuple):
    t: jnp.ndarray      # (R,), INF on miss
    idx: jnp.ndarray    # (R,) int32, best triangle index (0 if none)
    beta: jnp.ndarray   # (R,), barycentric at the best hit
    gamma: jnp.ndarray  # (R,)


def _block_mt(f, mt_block, eps_leaf):
    """MT over one triangle block: f (R,10) x mt_block (10,4,Tb) -> per-pair
    validity and t; returns (t_masked, beta, gamma) each (R, Tb)."""
    out = jnp.einsum(
        "rk,kct->rct",
        f,
        mt_block,
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32,
    )
    denom = out[:, 0, :]
    beta = out[:, 1, :] / denom
    gamma = out[:, 2, :] / denom
    t = out[:, 3, :] / denom
    valid = (
        (denom != 0.0)
        & (beta >= 0.0) & (beta <= 1.0)
        & (gamma >= 0.0) & (gamma <= 1.0)
        & (beta + gamma <= 1.0)
        & (t > 0.0)
        & (t > eps_leaf)
    )
    return jnp.where(valid, t, INF), beta, gamma


def intersect_tris_dense(
    O: Vec3,
    u: Vec3,
    tab: TriTables,
    eps_leaf: float,
    block_tris: int = 512,
) -> TriHit:
    """Closest-hit over all triangles: scan over triangle blocks with a
    running min (never materializes (R, T)).

    eps_leaf reproduces the per-variant leaf epsilon: 1e-4 in
    global_launcher.cu:274 / cpu_launcher.cpp:301, 1e-3 in
    realtime_render.cu:298, 0 in optimized.cu:275.
    """
    f = ray_features(O, u)
    Tp = tab.mt.shape[-1]
    assert Tp % block_tris == 0, (Tp, block_tris)
    nblk = Tp // block_tris
    mt_blocks = tab.mt.reshape(NUM_RAY_FEATURES, NUM_TRI_OUTPUTS, nblk, block_tris)

    R = O.x.shape[0]
    init = (
        jnp.full_like(O.x, INF),
        jnp.zeros_like(O.x, dtype=jnp.int32),
        jnp.zeros_like(O.x),
        jnp.zeros_like(O.x),
    )

    iota = np.arange(block_tris, dtype=np.int32)

    def body(carry, blk):
        mt_blk, base = blk
        t_best, i_best, b_best, g_best = carry
        t, beta, gamma = _block_mt(f, mt_blk, eps_leaf)
        # Winner recovery via masked reduces instead of argmin +
        # take_along_axis: elementwise ops, no row gathers.
        t_loc = jnp.min(t, axis=1)
        # Lowest index wins exact-t ties (reference's ascending strict-<
        # scan, global_launcher.cu:268-278), and beta/gamma come from the
        # same winning triangle.
        j = jnp.min(
            jnp.where(t == t_loc[:, None], iota[None, :], block_tris), axis=1
        )
        m = iota[None, :] == j[:, None]
        b_loc = jnp.max(jnp.where(m, beta, -jnp.inf), axis=1)
        g_loc = jnp.max(jnp.where(m, gamma, -jnp.inf), axis=1)
        j = jnp.minimum(j, block_tris - 1)
        better = t_loc < t_best
        carry = (
            jnp.where(better, t_loc, t_best),
            jnp.where(better, (base + j).astype(jnp.int32), i_best),
            jnp.where(better, b_loc, b_best),
            jnp.where(better, g_loc, g_best),
        )
        return carry, None

    bases = (np.arange(nblk) * block_tris).astype(np.int32)
    (t_best, i_best, b_best, g_best), _ = jax.lax.scan(
        body, init, (jnp.moveaxis(mt_blocks, 2, 0), bases)
    )
    return TriHit(t=t_best, idx=i_best, beta=b_best, gamma=g_best)


def geometric_normal(tab: TriTables, hit: TriHit) -> Vec3:
    """Unnormalized geometric normal of the winning triangle (the reference
    returns cross(e1,e2) of the best hit, normalized afterwards:
    global_launcher.cu:270-282).  One (R, 16) row gather."""
    rows = tab.cornersT[hit.idx]
    return Vec3(rows[:, 9], rows[:, 10], rows[:, 11])


def smooth_normal(tab: TriTables, hit: TriHit) -> Vec3:
    """Phong-interpolated vertex normal at the hit, matching
    get_smooth_normal (realtime_render.cu:221-245): alpha = 1 - beta - gamma,
    N = alpha*Na + beta*Nb + gamma*Nc, normalized.  One row gather."""
    alpha = 1.0 - hit.beta - hit.gamma
    rows = tab.cornersT[hit.idx]
    na = Vec3(rows[:, 0], rows[:, 1], rows[:, 2])
    nb = Vec3(rows[:, 3], rows[:, 4], rows[:, 5])
    nc = Vec3(rows[:, 6], rows[:, 7], rows[:, 8])
    n = na * alpha + nb * hit.beta + nc * hit.gamma
    return n

"""Wavefront path-tracing integrator.

Wavefront re-design of ``Scene::getColorIterative``
(global_launcher.cu:738-839).  The CUDA version runs one divergent thread per
pixel with per-depth arrays ``types[] / direct_colors[] / indirect_albedos[]``
and a backward composite

    ans = indirect_albedo[i] * ans + direct_color[i]   (only where types[i]==1)

(global_launcher.cu:830-838).  Here the whole ray batch advances in lockstep
through a ``lax.scan`` over depth; material branches become masks merged with
``jnp.where`` (no divergence — every lane executes the same dense ops), and
the per-depth stacks are the scan's stacked outputs.  The backward composite
is a second (reversed) scan with exactly the reference's recurrence.

Material semantics preserved exactly (same formulas, same epsilons):

- mirror:   u' = u - 2(u.N)N, origin offset +eps*N (global_launcher.cu:749-756)
- refract:  Snell with medium tracking via ray.refraction_index, N flipped
            when exiting, total-internal-reflection branch
            (global_launcher.cu:757-786); note the TIR ray keeps its medium
            and the transmitted ray switches to the entered medium's index
- diffuse:  shadow ray toward the point light; occluded iff the shadow hit's
            squared distance <= |L-P_adj|^2 (global_launcher.cu:790-799);
            direct = intensity/(4 pi |L-P|^2) * max(N.w,0) * albedo/pi
            (global_launcher.cu:800-807); cosine-weighted bounce with the
            reference's tangent frame; the bounce ray RESETS the medium to
            1.0 (Ray ctor default, global_launcher.cu:95 — the reference's
            behavior, kept for parity)
- miss:     type stays 0 and the lane's ray is left unchanged (the reference
            re-intersects the same ray and keeps missing; in the enclosed
            scenes only a path that starts inside a wall sphere can miss,
            e.g. a bounce off the cat's feet, which sink 0.06 units into
            the floor sphere in the array_bvh placement)
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from raytracinggpu.core.rays import RayBatch
from raytracinggpu.core.rng import cosine_hemisphere
from raytracinggpu.core.vec import Vec3, vgather, vwhere
from raytracinggpu.ops.sphere import INF, intersect_spheres
from raytracinggpu.ops.triangle import (
    geometric_normal,
    intersect_tris_dense,
    smooth_normal,
)
from raytracinggpu.scene.scene import RenderConfig, SceneTables

PI = np.float32(np.pi)


class Hit(NamedTuple):
    t: jnp.ndarray    # (R,), INF on miss
    obj: jnp.ndarray  # (R,) int32 object id, -1 on miss
    N: Vec3           # unit normal (masked lanes arbitrary)
    P: Vec3           # hit point O + t*u (masked lanes arbitrary)


def _mesh_hit(scene: SceneTables, cfg: RenderConfig, O: Vec3, u: Vec3):
    """Closest mesh hit under the configured traversal."""
    if cfg.traversal == "walk":
        from raytracinggpu.ops.walk import intersect_tris_walk

        return intersect_tris_walk(O, u, scene.walk, cfg.eps_leaf)
    if cfg.traversal == "dense":
        return intersect_tris_dense(O, u, scene.mesh, cfg.eps_leaf,
                                    cfg.tri_block)
    if cfg.traversal == "bvh":
        from raytracinggpu.ops.bvh_traverse import intersect_tris_bvh

        return intersect_tris_bvh(
            O, u, scene.mesh, scene.bvh, cfg.eps_leaf,
            max_leaf_tris=cfg.bvh_max_leaf,
            node_layout=cfg.bvh_node_layout,
        )
    raise ValueError(f"unknown traversal mode {cfg.traversal!r}")


def intersect_all(scene: SceneTables, cfg: RenderConfig, O: Vec3, u: Vec3) -> Hit:
    """Scene-wide nearest hit: batched sphere pass + mesh pass merged by
    min-t (Scene::intersect_all, global_launcher.cu:716-736).  The mesh holds
    the highest object id, and the reference's ascending-id strict `<` scan
    means the mesh only wins strictly — reproduced by the `<` below."""
    t_s, obj_s, N_s = intersect_spheres(O, u, scene.spheres)

    if scene.mesh is None:
        t, obj, N = t_s, obj_s, N_s
    else:
        mh = _mesh_hit(scene, cfg, O, u)
        if cfg.smooth_normals:
            # realtime_render.cu:309-311: after the closest hit, the geometric
            # normal is replaced by the Phong-interpolated vertex normal.
            N_m = smooth_normal(scene.mesh, mh)
        else:
            N_m = geometric_normal(scene.mesh, mh)
        nn = N_m.norm()
        N_m = N_m / jnp.where(nn > 0.0, nn, 1.0)

        use_mesh = mh.t < t_s
        t = jnp.where(use_mesh, mh.t, t_s)
        obj = jnp.where(use_mesh, np.int32(cfg.mesh_object_id), obj_s)
        obj = jnp.where(t < INF, obj, -1)
        N = vwhere(use_mesh, N_m, N_s)

    hit = obj >= 0
    t_safe = jnp.where(hit, t, 0.0)  # avoid inf*0 NaN on miss lanes
    P = O + u * t_safe
    return Hit(t=t, obj=obj, N=N, P=P)


def occlusion_distance(scene: SceneTables, cfg: RenderConfig, O: Vec3, u: Vec3,
                       Lv: Vec3, active=None):
    """Distance for the shadow ray's occlusion test, which compares its
    square against |L - P_adj|^2 (global_launcher.cu:795-799).  The walk
    mode runs the any-hit kernel, which stops a lane at the first hit
    inside that bound; the other modes reuse the full closest hit.

    active: (R,) bool — lanes whose occlusion result is provably unused
    (non-diffuse, missed, or N.wl <= 0 so the direct term is exactly zero,
    global_launcher.cu:800-807).  The walk skips them; the returned
    distance on inactive lanes is then the sphere-only distance, which the
    integrator never reads."""
    if scene.mesh is not None and cfg.traversal == "walk":
        from raytracinggpu.ops.walk import intersect_tris_walk_shadow

        t_sph, _, _ = intersect_spheres(O, u, scene.spheres)
        cap2 = Lv.norm2()
        # A lane a sphere already occludes is occluded whatever the mesh
        # says (min(t_sph, t_mesh) only shrinks), so it needs no walk.
        if active is not None:
            active = active & ~(t_sph * t_sph <= cap2)
        t_mesh = intersect_tris_walk_shadow(
            O, u, scene.walk, cfg.eps_leaf, cap2, active=active)
        return jnp.minimum(t_sph, t_mesh)
    sh = intersect_all(scene, cfg, O, u)
    return jnp.where(sh.obj >= 0, sh.t, INF)


class TraceStats(NamedTuple):
    """Per-depth lane counts (the observability the reference lacks;
    SURVEY.md §5 'metrics fall out of the wavefront masks for free')."""

    hit: jnp.ndarray      # (D,) int32
    mirror: jnp.ndarray
    refract: jnp.ndarray
    tir: jnp.ndarray
    diffuse: jnp.ndarray
    shadowed: jnp.ndarray


def trace(
    scene: SceneTables,
    cfg: RenderConfig,
    O: Vec3,
    u: Vec3,
    uniforms: jnp.ndarray,
) -> tuple[Vec3, TraceStats]:
    """Path-trace a ray batch to its final color.

    Args:
      O, u: primary rays, components (R,).
      uniforms: (max_depth, 2, R) pre-drawn U(0,1] — the two per-depth
        uniforms of the diffuse bounce (global_launcher.cu:810-811).  Drawn
        outside so an oracle can be fed identical numbers.
    Returns:
      (color Vec3 (R,), TraceStats).
    """
    mats = scene.materials
    eps = np.float32(cfg.eps_bounce)
    R = O.x.shape[0]

    def depth_step(ray: RayBatch, xs):
        O, u, ri = ray
        r1, r2 = xs[0], xs[1]

        h = intersect_all(scene, cfg, O, u)
        hit = h.obj >= 0
        oid = jnp.maximum(h.obj, 0)  # clamp for gathers; lanes masked by `hit`
        N, P = h.N, h.P

        is_mirror = hit & mats.mirror[oid]
        in_ri_o = mats.in_ri[oid]
        out_ri_o = mats.out_ri[oid]
        is_refr = hit & (~mats.mirror[oid]) & (in_ri_o != out_ri_o)
        is_diff = hit & (~is_mirror) & (~is_refr)

        # ---- mirror (global_launcher.cu:749-756) ----
        u_mir = u - N * (2.0 * u.dot(N))
        O_mir = P + N * eps

        # ---- refraction (global_launcher.cu:757-786) ----
        out2in = ri == out_ri_o
        ratio = jnp.where(out2in, out_ri_o / in_ri_o, in_ri_o / out_ri_o)
        N2 = vwhere(out2in, N, -N)
        cosi = u.dot(N2)
        sin2t = ratio * ratio * (1.0 - cosi * cosi)
        denser_to_lighter = jnp.where(out2in, ri > in_ri_o, ri > out_ri_o)
        is_tir = is_refr & denser_to_lighter & (sin2t > 1.0)
        u_tir = u - N2 * (2.0 * cosi)
        O_tir = P + N2 * eps
        u_ref = N2 * (-jnp.sqrt(jnp.maximum(1.0 - sin2t, 0.0))) + (
            u - N2 * cosi
        ) * ratio
        O_ref = P - N2 * eps
        ri_ref = jnp.where(out2in, in_ri_o, out_ri_o)

        # ---- diffuse (global_launcher.cu:788-827) ----
        P_adj = P + N * eps
        Lv = scene.L - P_adj
        shadow_dir = Lv.normalized()
        LP = scene.L - P
        wl = LP.normalized()
        ndwl = N.dot(wl)
        # Shadow work is provably unused where the lane is not diffuse or
        # the light is behind the surface (max(N.wl, 0) = 0 makes the
        # direct term exactly zero, global_launcher.cu:800-807) — the
        # walk skips those lanes; the image is bit-identical.
        sh_active = is_diff & (ndwl > 0.0)
        t_sh = occlusion_distance(
            scene, cfg, P_adj, shadow_dir, Lv, active=sh_active)
        occluded = t_sh * t_sh <= Lv.norm2()

        lum = (
            scene.intensity / (4.0 * PI * LP.norm2())
            * jnp.maximum(ndwl, 0.0)
        )
        alb = vgather(mats.albedo, oid)
        lit = is_diff & (~occluded)
        direct = alb * jnp.where(lit, lum / PI, 0.0)

        u_dif = cosine_hemisphere(r1, r2, N)
        # Ray ctor default: bounce rays reset to medium 1.0
        # (global_launcher.cu:824 constructs Ray without an index).
        ri_dif = jnp.ones_like(ri)

        # ---- merge next-ray state; misses keep their ray unchanged ----
        O2, u2, ri2 = O, u, ri
        O2 = vwhere(is_mirror, O_mir, O2)
        u2 = vwhere(is_mirror, u_mir, u2)
        O2 = vwhere(is_tir, O_tir, vwhere(is_refr & ~is_tir, O_ref, O2))
        u2 = vwhere(is_tir, u_tir, vwhere(is_refr & ~is_tir, u_ref, u2))
        ri2 = jnp.where(is_refr & ~is_tir, ri_ref, ri2)
        O2 = vwhere(is_diff, P_adj, O2)
        u2 = vwhere(is_diff, u_dif, u2)
        ri2 = jnp.where(is_diff, ri_dif, ri2)

        counts = jnp.stack(
            [
                jnp.sum(hit),
                jnp.sum(is_mirror),
                jnp.sum(is_refr),
                jnp.sum(is_tir),
                jnp.sum(is_diff),
                # counted only where the shadow query is meaningful, so the
                # stat is identical across traversal modes (masked lanes'
                # occlusion is undefined in walk mode)
                jnp.sum(sh_active & occluded),
            ]
        ).astype(jnp.int32)
        out = (is_diff, direct, alb, counts)
        return RayBatch(O2, u2, ri2), out

    # The scan carry is the wavefront's RayBatch — the SoA form of the
    # reference's medium-tracking Ray {O, u, refraction_index}
    # (global_launcher.cu:93-99); primary rays start in medium 1.0.
    D = uniforms.shape[0]
    unroll = max(1, min(int(cfg.depth_unroll), D))
    _, (types, directs, albedos, counts) = jax.lax.scan(
        depth_step, RayBatch.make(O, u), uniforms, unroll=unroll,
    )

    # ---- backward composite (global_launcher.cu:830-838) ----
    def comp_step(ans, xs):
        is_diff, direct, alb = xs
        ans = vwhere(is_diff, alb * ans + direct, ans)
        return ans, None

    ans, _ = jax.lax.scan(
        comp_step, Vec3.zeros((R,)), (types, directs, albedos), reverse=True
    )

    stats = TraceStats(
        hit=counts[:, 0],
        mirror=counts[:, 1],
        refract=counts[:, 2],
        tir=counts[:, 3],
        diffuse=counts[:, 4],
        shadowed=counts[:, 5],
    )
    return ans, stats

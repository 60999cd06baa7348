"""Full differential for config 5's unique semantics: yaw/pitch camera with
the point quirk + smooth Phong normals, vs the oracle with injected
uniforms."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from raytracinggpu.core.vec import Vec3
from raytracinggpu.integrator.wavefront import trace
from raytracinggpu.oracle.numpy_ref import OracleScene
from raytracinggpu.scene.presets import build_preset, wall_spheres
from raytracinggpu.render.pipeline import Camera


def _realtime_rays(W, H, cam_c=(0.0, 0.0, 55.0), yaw=0.0, pitch=0.3,
                   fov=np.pi / 2):
    """Reference realtime raygen (realtime_render.cu:1112-1123): yaw/pitch
    basis, u_center includes cam.C (the point quirk), zero jitter."""
    bx = np.array([1.0, 0.0, 0.0])
    by = np.array([0.0, 1.0, 0.0])
    bz = np.array([0.0, 0.0, -1.0])
    cy, sy = np.cos(yaw), np.sin(yaw)
    bx = bx * cy + bz * sy
    bz = np.cross(by, bx)
    cp, sp = np.cos(pitch), np.sin(pitch)
    by = by * cp - bz * sp
    bz = np.cross(bx, by)
    bx /= np.linalg.norm(bx); by /= np.linalg.norm(by); bz /= np.linalg.norm(bz)

    z = -W / (2 * np.tan(fov / 2))
    x = np.arange(W, dtype=np.float32)
    y = np.arange(H, dtype=np.float32)
    ux = np.tile(x - W / 2 + 0.5, H)
    uy = np.repeat(H / 2 - y - 0.5, W)
    C = np.asarray(cam_c, np.float32)
    d = C[None, :] + bz[None, :] * z + bx[None, :] * ux[:, None] + by[None, :] * uy[:, None]
    u = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    O = np.tile(C, (W * H, 1)).astype(np.float32)
    return O, u


def test_realtime_config_matches_oracle(cat_mesh_raw, rng):
    from raytracinggpu.scene.mesh import build_mesh, rescale

    obj = cat_mesh_raw
    verts = rescale(obj.vertices, 0.6, (0, -10, 0))
    obj2 = dataclasses.replace(obj, vertices=verts)
    mesh = build_mesh(obj2)
    cfg, tables = build_preset("realtime", mesh=mesh, traversal="dense")
    W = H = 20
    cfg = dataclasses.replace(cfg, width=W, height=H, spp=1, max_depth=2,
                              traversal="walk")

    # Oracle with smooth normals in ORIGINAL triangle order.
    A = verts[obj.vtx[:, 0]]
    B = verts[obj.vtx[:, 1]]
    C = verts[obj.vtx[:, 2]]
    Na = obj.normals[obj.nrm[:, 0]]
    Nb = obj.normals[obj.nrm[:, 1]]
    Nc = obj.normals[obj.nrm[:, 2]]
    spheres, mats = wall_spheres(940.0)
    oracle = OracleScene(
        spheres, mats, L=(0, 15, 40), intensity=3e10,
        tris=(A, B, C), mesh_mat=((0.25, 0.25, 0.25), False, 1.0, 1.0),
        tri_normals=(Na, Nb, Nc),
    )

    O, u = _realtime_rays(W, H)
    R = W * H
    depth = 2
    uniforms = rng.random((depth, 2, R)).astype(np.float32) * 0.998 + 1e-3
    Ov = Vec3(*(jnp.asarray(O[:, i]) for i in range(3)))
    uv = Vec3(*(jnp.asarray(u[:, i]) for i in range(3)))
    col, stats = jax.jit(trace, static_argnums=1)(
        tables, cfg, Ov, uv, jnp.asarray(uniforms)
    )
    ref = oracle.trace(O, u, uniforms, depth, cfg.eps_bounce, cfg.eps_leaf)
    got = np.stack([np.asarray(c) for c in col], -1)
    bad = np.abs(got - ref) > 3e-3 * np.abs(ref) + 3.0
    frac = bad.any(-1).mean()
    assert frac < 0.04, f"{frac:.2%} rays disagree (smooth-normal path)"

    # Also cross-check our raygen against the independent numpy camera.
    cam = Camera.from_yaw_pitch((0.0, 0.0, 55.0), 0.0, 0.3)
    from raytracinggpu.render.pipeline import raygen

    Og, ug = raygen(cfg, cam, jnp.zeros(R), jnp.zeros(R))
    np.testing.assert_allclose(
        np.stack([np.asarray(c) for c in ug], -1), u, atol=2e-6
    )


def test_smooth_normals_walk_matches_dense(cat_mesh_raw):
    """The walk kernel's winner (idx, beta, gamma) feeds the same Phong
    normal recovery as dense, so the smooth-normal render must reproduce
    the dense reference's."""
    import numpy as np

    from raytracinggpu.render.pipeline import render_preset_frame
    from raytracinggpu.scene.mesh import build_mesh
    from raytracinggpu.scene.presets import build_preset

    mesh = build_mesh(cat_mesh_raw)
    imgs = {}
    for trav in ("dense", "walk"):
        cfg, tables = build_preset(
            "realtime", mesh=mesh, width=32, height=32, spp=1, max_depth=2,
            traversal=trav)
        assert cfg.smooth_normals
        imgs[trav], _ = render_preset_frame(tables, cfg, seed=3)
    # Same fraction-based tolerance as the ray-level differential above:
    # dense evaluates MT as a matrix product and the walk as scalar sums,
    # so a grazing-edge pixel can legitimately flip its closest-hit winner
    # and take a different material branch — bounded by count, not by
    # magnitude.
    bad = np.abs(imgs["walk"] - imgs["dense"]) > (
        1e-4 * np.abs(imgs["dense"]) + 2e-2)
    frac = bad.any(-1).mean()
    assert frac < 0.01, f"{frac:.2%} pixels disagree with the dense oracle"

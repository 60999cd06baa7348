"""Preset parameter parity with the reference launchers (SURVEY.md §2.7
table) — these deltas are 'easy to get silently wrong' per the survey, so
every one is pinned here."""
import numpy as np
import pytest

from raytracinggpu.scene.presets import build_preset, make_config


@pytest.fixture(scope="module")
def preset_cache(cat_mesh_raw):
    from raytracinggpu.scene.mesh import build_mesh

    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = build_preset(name)
        return cache[name]

    return get


def test_config_deltas():
    cpu = make_config("cpu")
    assert cpu.sigma == 0.0 and cpu.eps_bounce == 1e-3 and cpu.eps_leaf == 1e-4
    glob = make_config("global")
    assert glob.sigma == 0.2 and glob.eps_bounce == 1e-4 and glob.eps_leaf == 1e-4
    opt = make_config("optimized")
    assert opt.eps_leaf == 0.0
    rt = make_config("realtime")
    assert rt.spp == 20 and rt.max_depth == 3
    assert np.isclose(rt.fov, np.pi / 2)
    assert rt.smooth_normals and rt.camera_point_quirk
    assert np.isclose(make_config("cpu").fov, np.pi / 3)


def test_scene_tables_light_and_floor(preset_cache):
    _, t_global = preset_cache("global")
    assert (float(t_global.L.x), float(t_global.L.y), float(t_global.L.z)) == (-10.0, 20.0, 40.0)
    assert float(t_global.intensity) == pytest.approx(3e10)
    # floor sphere: (0,-1000,0) R=990 (global_launcher.cu:856)
    r = np.asarray(t_global.spheres.radius)
    cy = np.asarray(t_global.spheres.cy)
    assert r[1] == 990.0 and cy[1] == -1000.0

    _, t_rt = preset_cache("realtime")
    assert (float(t_rt.L.x), float(t_rt.L.y), float(t_rt.L.z)) == (0.0, 15.0, 40.0)
    # realtime floor radius 940 (realtime_render.cu:1027)
    assert np.asarray(t_rt.spheres.radius)[1] == 940.0


def test_wall_albedos(preset_cache):
    _, t = preset_cache("global")
    alb = np.stack([np.asarray(t.materials.albedo.x),
                    np.asarray(t.materials.albedo.y),
                    np.asarray(t.materials.albedo.z)], -1)
    np.testing.assert_array_equal(alb[0], [0, 1, 0])  # green fore
    np.testing.assert_array_equal(alb[1], [0, 0, 1])  # blue floor
    np.testing.assert_array_equal(alb[2], [1, 0, 0])  # red ceiling
    np.testing.assert_array_equal(alb[3], [0, 1, 1])  # cyan left
    np.testing.assert_array_equal(alb[4], [1, 1, 0])  # yellow right
    np.testing.assert_array_equal(alb[5], [1, 0, 1])  # magenta back
    np.testing.assert_allclose(alb[6], [0.25, 0.25, 0.25])  # cat


def test_mesh_transform_chains(cat_mesh_raw):
    """cpu: v*0.8+(0,-10,0); global/optimized: v*0.48+(0,-10,0);
    array_bvh/realtime: v*0.6+(0,-10,0) (SURVEY.md §2.7)."""
    from raytracinggpu.scene.mesh import load_cat_mesh
    from raytracinggpu.scene.obj import CAT_OBJ_PATH
    from raytracinggpu.scene.presets import _MESH_TRANSFORM

    v0 = cat_mesh_raw.vertices
    expect = {
        "cpu": (0.8, -10.0),
        "global": (0.48, -10.0),
        "optimized": (0.48, -10.0),
        "array_bvh": (0.6, -10.0),
        "realtime": (0.6, -10.0),
    }
    for preset, (scale, ty) in expect.items():
        embed, s, off = _MESH_TRANSFORM[preset]
        mesh = load_cat_mesh(CAT_OBJ_PATH, embed, s, off)
        # Compare overall bbox against the analytic transform.
        got_mn = np.minimum.reduce([mesh.A.min(0), mesh.B.min(0), mesh.C.min(0)])
        exp_mn = v0.min(0) * scale + np.array([0, ty, 0], np.float32)
        np.testing.assert_allclose(got_mn, exp_mn, rtol=1e-4, atol=1e-3)


def test_showcase_materials():
    _, t = preset = build_preset("showcase")
    mirror = np.asarray(t.materials.mirror)
    in_ri = np.asarray(t.materials.in_ri)
    out_ri = np.asarray(t.materials.out_ri)
    assert mirror[7] and not mirror[6]
    assert in_ri[8] == 1.5 and out_ri[8] == 1.0  # glass shell
    assert in_ri[9] == 1.0 and out_ri[9] == 1.5  # nested bubble


def test_showcase_refraction_matches_oracle(rng):
    """Mirror + refraction + TIR differential coverage with injected
    uniforms (the commented-out object library of cpu_launcher.cpp:668-672
    as a live scene)."""
    import dataclasses
    import jax
    import jax.numpy as jnp

    from raytracinggpu.integrator.wavefront import trace
    from raytracinggpu.oracle.numpy_ref import OracleScene
    from raytracinggpu.scene.presets import wall_spheres
    from tests.test_integrator import _camera_rays, _vec

    cfg, tables = build_preset("showcase", width=24, height=24, spp=1, max_depth=4)
    spheres, mats = wall_spheres(990.0)
    spheres += [((0.0, 0.0, 18.0), 5.0), ((-13.0, 0.0, 18.0), 5.0),
                ((13.0, 0.0, 18.0), 5.0), ((13.0, 0.0, 18.0), 4.5)]
    mats += [((1.0, 1.0, 1.0), False, 1.0, 1.0),
             ((0.0, 0.0, 0.0), True, 1.0, 1.0),
             ((0.0, 0.0, 0.0), False, 1.5, 1.0),
             ((0.0, 0.0, 0.0), False, 1.0, 1.5)]
    oracle = OracleScene(spheres, mats, L=(-10, 20, 40), intensity=3e10)

    W = H = 24
    O, u = _camera_rays(W, H)
    depth = 4
    uniforms = rng.random((depth, 2, W * H)).astype(np.float32) * 0.998 + 1e-3
    col, stats = jax.jit(trace, static_argnums=1)(
        tables, cfg, _vec(O), _vec(u), jnp.asarray(uniforms)
    )
    ref = oracle.trace(O, u, uniforms, depth, cfg.eps_bounce, cfg.eps_leaf)
    got = np.stack([np.asarray(col.x), np.asarray(col.y), np.asarray(col.z)], -1)
    bad = np.abs(got - ref) > 2e-3 * np.abs(ref) + 2.0
    assert bad.any(-1).mean() < 0.03
    # All three special material branches exercised.
    assert int(np.asarray(stats.mirror).sum()) > 0
    assert int(np.asarray(stats.refract).sum()) > 0

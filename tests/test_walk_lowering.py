"""What the CPU can check about the GPU program without a GPU.

- The walk kernel lowers for CUDA through Triton (``jax.export`` with
  ``platforms=["cuda"]`` emits the Triton custom call), for both variants.
- The one platform decision (ops/walk._interpret): the CPU interprets,
  a GPU compiles, and any other platform is refused.
- The render program picks the kernel the config names, and every float32
  contraction on the mesh path asks for Precision.HIGHEST (a GPU may
  otherwise run it in TF32).
- On a GPU (``gpu`` marker; skipped elsewhere) the compiled kernel matches
  dense; ``chip_smoke.py`` runs the same check at the headline shape.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import export

from raytracinggpu.core.vec import Vec3
from raytracinggpu.ops import walk
from raytracinggpu.render.pipeline import Camera, render_frame
from raytracinggpu.scene.presets import build_preset

TRITON_CALL = "__gpu$xla.gpu.triton"


@pytest.fixture(scope="module")
def cat():
    return build_preset("array_bvh", width=16, height=16, spp=1,
                        max_depth=2)


def _rays(n=100):
    rng = np.random.default_rng(0)
    o = rng.uniform(-20, 20, (n, 3)).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    vec = lambda a: Vec3(*(jnp.asarray(a[:, i]) for i in range(3)))
    return vec(o), vec(d)


def _cuda_module(fn, *args):
    exp = export.export(
        jax.jit(fn), platforms=["cuda"],
        disabled_checks=[export.DisabledSafetyCheck.custom_call(TRITON_CALL)],
    )(*args)
    return exp.mlir_module()


@pytest.mark.parametrize("variant", ["closest", "shadow"])
def test_cuda_lowering_emits_triton_call(cat, variant, monkeypatch):
    _, tables = cat
    O, u = _rays()
    monkeypatch.setattr(walk, "_interpret", lambda: False)
    if variant == "closest":
        fn = lambda O, u: walk.intersect_tris_walk(O, u, tables.walk, 1e-4)
    else:
        fn = lambda O, u: walk.intersect_tris_walk_shadow(
            O, u, tables.walk, 1e-4, u.x * 0 + 100.0, active=O.x > 0)
    text = _cuda_module(fn, O, u)
    assert text.count(TRITON_CALL) == 1
    assert f"bvh_walk_{variant}" in text


def test_cpu_interprets():
    assert jax.default_backend() == "cpu"
    assert walk._interpret() is True


def test_gpu_compiles(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert walk._interpret() is False


@pytest.mark.parametrize("platform", ["rocm", "metal"])
def test_other_platforms_refused(monkeypatch, platform):
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    with pytest.raises(RuntimeError, match=platform):
        walk._interpret()


def _eqns(jaxpr):
    """Every equation of a jaxpr and of the jaxprs nested in its params."""
    for eqn in jaxpr.eqns:
        yield eqn
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (list, tuple)) else [v]):
                inner = getattr(sub, "jaxpr", sub)
                if hasattr(inner, "eqns"):
                    yield from _eqns(inner)


def _render_eqns(traversal):
    cfg, tables = build_preset("array_bvh", width=8, height=8, spp=1,
                               max_depth=2, traversal=traversal)
    closed = jax.make_jaxpr(
        lambda s, c, k: render_frame(s, cfg, c, k))(
        tables, Camera.fixed(cfg.camera_c), jax.random.PRNGKey(0))
    return list(_eqns(closed.jaxpr))


@pytest.mark.parametrize("traversal", ["walk", "dense", "bvh"])
def test_mesh_path_contractions_are_highest(traversal):
    dots = [e for e in _render_eqns(traversal)
            if e.primitive.name == "dot_general"]
    if traversal != "walk":
        assert dots, "the reference modes contract on the mesh path"
    for e in dots:
        prec = e.params["precision"]
        precs = prec if isinstance(prec, tuple) else (prec,)
        assert all(p == jax.lax.Precision.HIGHEST for p in precs), prec


@pytest.mark.parametrize("traversal", ["walk", "dense"])
def test_render_program_picks_the_configured_kernel(traversal):
    calls = [e for e in _render_eqns(traversal)
             if e.primitive.name == "pallas_call"]
    names = {e.params["name"] for e in calls}
    assert all(e.params["backend"] == "triton" for e in calls)
    want = {"bvh_walk_closest", "bvh_walk_shadow"}
    assert names == (want if traversal == "walk" else set())


@pytest.mark.gpu
def test_compiled_walk_matches_dense_on_gpu(gpu_device):
    """The chip_smoke.py kernel phase at a small width, on the card."""
    import chip_smoke

    report = chip_smoke.compare_casts(width=128, height=128, spp_fuse=1)
    assert report["closest"]["idx_agree"] >= 0.9999
    assert report["shadow"]["pred_agree"] >= 0.9999

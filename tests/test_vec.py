"""Core SoA vector math vs numpy."""
import jax.numpy as jnp
import numpy as np

from raytracinggpu.core.vec import Vec3, vwhere


def _mk(rng, n=64):
    a = rng.standard_normal((n, 3)).astype(np.float32)
    return a, Vec3(jnp.asarray(a[:, 0]), jnp.asarray(a[:, 1]), jnp.asarray(a[:, 2]))


def test_ops_match_numpy(rng):
    a_np, a = _mk(rng)
    b_np, b = _mk(rng)
    np.testing.assert_allclose((a + b).to_array(), a_np + b_np, rtol=1e-6)
    np.testing.assert_allclose((a - b).to_array(), a_np - b_np, rtol=1e-6)
    np.testing.assert_allclose((a * 2.5).to_array(), a_np * 2.5, rtol=1e-6)
    np.testing.assert_allclose((a * b).to_array(), a_np * b_np, rtol=1e-6)
    np.testing.assert_allclose(a.dot(b), np.einsum("nd,nd->n", a_np, b_np), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(a.cross(b).to_array(), np.cross(a_np, b_np), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(a.norm(), np.linalg.norm(a_np, axis=1), rtol=1e-6)
    n = a.normalized().to_array()
    np.testing.assert_allclose(np.linalg.norm(n, axis=1), 1.0, rtol=1e-5)


def test_from_to_array(rng):
    a_np, a = _mk(rng)
    np.testing.assert_array_equal(Vec3.from_array(a_np).to_array(), a_np)
    np.testing.assert_array_equal(a.to_array(), a_np)


def test_vwhere(rng):
    a_np, a = _mk(rng)
    b_np, b = _mk(rng)
    m = rng.random(64) > 0.5
    out = vwhere(jnp.asarray(m), a, b).to_array()
    np.testing.assert_array_equal(out, np.where(m[:, None], a_np, b_np))

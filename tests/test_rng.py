"""Counter-PRNG sampling: distribution sanity + exact reference formulas."""
import jax
import jax.numpy as jnp
import numpy as np

from raytracinggpu.core.rng import (
    box_muller_jitter,
    cosine_hemisphere,
    tangent_frame,
    uniform_open0,
)
from raytracinggpu.core.vec import Vec3


def test_uniform_support():
    u = np.asarray(uniform_open0(jax.random.PRNGKey(0), (200000,)))
    # curand_uniform support is (0, 1]: log(u) must be finite.
    assert u.min() > 0.0 and u.max() <= 1.0
    assert np.isfinite(np.log(u)).all()
    assert abs(u.mean() - 0.5) < 5e-3


def test_box_muller_moments():
    k = jax.random.PRNGKey(1)
    r = uniform_open0(k, (2, 200000))
    gx, gy = box_muller_jitter(r[0], r[1], sigma=0.2)
    gx, gy = np.asarray(gx), np.asarray(gy)
    assert abs(gx.mean()) < 2e-3 and abs(gy.mean()) < 2e-3
    assert abs(gx.std() - 0.2) < 2e-3 and abs(gy.std() - 0.2) < 2e-3
    # Exact formula: magnitude^2 = sigma^2 * (-2 ln r1)
    np.testing.assert_allclose(
        gx**2 + gy**2, 0.04 * (-2 * np.log(np.asarray(r[0]))), rtol=1e-4
    )


def test_tangent_frame_orthonormal(rng):
    n = rng.standard_normal((1000, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    N = Vec3(*(jnp.asarray(n[:, i]) for i in range(3)))
    t1, t2 = tangent_frame(N)
    t1a = np.stack([np.asarray(c) for c in t1], -1)
    t2a = np.stack([np.asarray(c) for c in t2], -1)
    np.testing.assert_allclose(np.linalg.norm(t1a, axis=1), 1.0, atol=1e-5)
    np.testing.assert_allclose((t1a * n).sum(1), 0.0, atol=1e-5)
    np.testing.assert_allclose((t1a * t2a).sum(1), 0.0, atol=1e-5)
    # Reference branch: when |Nx| and |Ny| nonzero, T1 = (-Ny, Nx, 0)
    i = np.where((np.abs(n[:, 0]) > 1e-6) & (np.abs(n[:, 1]) > 1e-6))[0][0]
    exp = np.array([-n[i, 1], n[i, 0], 0.0])
    np.testing.assert_allclose(t1a[i], exp / np.linalg.norm(exp), atol=1e-5)


def test_cosine_hemisphere_distribution():
    k = jax.random.PRNGKey(2)
    n = 200000
    r = uniform_open0(k, (2, n))
    N = Vec3.full((n,), 0.0, 0.0, 1.0)
    d = cosine_hemisphere(r[0], r[1], N)
    dz = np.asarray(d.z)
    # Cosine-weighted: E[cos theta] = 2/3, all samples above the surface.
    assert (dz >= 0).all()
    assert abs(dz.mean() - 2.0 / 3.0) < 5e-3
    # Unit length
    norm = np.asarray(d.norm())
    np.testing.assert_allclose(norm, 1.0, atol=1e-5)
    # z^2 = r2 exactly (reference formula global_launcher.cu:814)
    np.testing.assert_allclose(dz**2, np.asarray(r[1]), rtol=1e-4)


def test_missing_obj_raises(tmp_path):
    from raytracinggpu.scene.obj import read_obj

    try:
        read_obj(str(tmp_path / "nope.obj"))
        assert False, "expected FileNotFoundError"
    except FileNotFoundError:
        pass

"""Test environment: the CPU platform with 8 virtual devices, so
multi-device sharding is testable without a cluster (SURVEY.md §4), and the
BVH walk kernel runs in the Pallas interpreter (ops/walk._interpret).

The config update below must run before any JAX backend initializes.
Tests that need a GPU carry the ``gpu`` marker and decide inside the
``gpu_device`` fixture whether one exists, so every worker collects the
same tests.
"""
import os

# Perf-only default: the unrolled depth scan (RenderConfig.depth_unroll)
# multiplies every traced program's size ~5x — bit-identical results, but
# it more than doubles the CPU suite's compile-dominated runtime.  Pin it
# to 1 here; tests/test_integrator.py covers the unrolled path explicitly.
os.environ.setdefault("RT_DEPTH_UNROLL", "1")
# The suite compiles hundreds of small CPU programs: keep the persistent
# compilation cache off (utils/cache.py treats an empty value as "off").
os.environ.setdefault("JAX_COMPILATION_CACHE_DIR", "")

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

# RT_TEST_PLATFORMS=cuda,cpu runs the suite on a GPU, where the tests
# marked ``gpu`` then run instead of skipping.
jax.config.update("jax_platforms", os.environ.get("RT_TEST_PLATFORMS", "cpu"))

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_sessionstart(session):
    """Make a missing native build LOUD: without librt_native.so the 4
    native-equality tests skip, which is easy to miss in a green run.
    One `make -C native` builds it."""
    from raytracinggpu import native

    if not native.available():
        import warnings

        warnings.warn(
            "librt_native.so not built — the native C++ equality tests "
            "(tests/test_native.py) will SKIP.  Run `make -C native` first "
            "for full coverage.",
            stacklevel=1,
        )


@pytest.fixture()
def rng():
    # Function-scoped: every test sees the same deterministic stream
    # regardless of which other tests ran before it.
    return np.random.default_rng(1234)


@pytest.fixture(scope="session")
def cat_mesh_raw():
    """Parsed cat OBJ without transforms (session-cached)."""
    from raytracinggpu.scene.obj import CAT_OBJ_PATH, read_obj

    return read_obj(CAT_OBJ_PATH)


@pytest.fixture()
def gpu_device():
    """The first GPU, or a skip: decided at run time, never at import."""
    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip("needs an NVIDIA GPU (run `python chip_smoke.py` on one)")
    return devs[0]

"""Test configuration: run on a virtual 8-device CPU mesh unless JAX_PLATFORMS
names another platform.

Multi-card hardware is unavailable in CI; tests exercise sharding on
xla_force_host_platform_device_count=8 virtual CPU devices (the "fake cluster" the
reference lacks — SURVEY.md §4 implication (d)). Tests marked `gpu` need an
NVIDIA card and skip elsewhere; chip_smoke.py runs them on the card."""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

import numpy as np
import pytest

from vectorgraphlibrary.io import generation
from vectorgraphlibrary.io.edges_container import EdgesContainer
from vectorgraphlibrary.runtime.cache import enable_persistent_cache

# persistent compilation cache: XLA compiles of the tiled kernels dominate test
# wall time; cache them across runs
enable_persistent_cache()


@pytest.fixture(scope="session")
def small_rmat() -> EdgesContainer:
    return generation.rmat(scale=10, avg_degree=8, seed=3)


@pytest.fixture(scope="session")
def small_ru() -> EdgesContainer:
    return generation.random_uniform(scale=9, avg_degree=5, seed=7)


@pytest.fixture
def gpu():
    """Skips unless the default device is an NVIDIA GPU (decided at test time,
    never at collection, so every worker collects the same tests)."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (run on the card by chip_smoke.py)")


def coo_to_dense(ec: EdgesContainer, weights: bool = False) -> np.ndarray:
    """Oracle helper: dense adjacency (dst, src) counts or weight sums."""
    a = np.zeros((ec.vertices_count, ec.vertices_count),
                 dtype=np.float64 if weights else np.int64)
    w = ec.weights if weights else np.ones(ec.edges_count, dtype=np.int64)
    np.add.at(a, (ec.dst_ids, ec.src_ids), w)
    return a

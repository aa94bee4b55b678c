"""Test harness: force an 8-device CPU platform BEFORE jax is imported.

This is the JAX analog of the reference's "multi-node without a cluster":
shard-count invariance is validated on a virtual 8-device mesh
(XLA --xla_force_host_platform_device_count), mirroring how the reference's
correctness relies on rank-count-invariant Allreduce results (SURVEY §4.5).

Tests marked `gpu` check what only the card can show.  They run under
`VAMPOMI_TEST_GPU=1 python -m pytest tests -m gpu` on a GPU machine (as
chip_smoke.py's gpu-tests phase does), where the platform is left to JAX;
everywhere else their `gpu` fixture skips them.  The env var only picks the
platform: every process collects the same tests.
"""

import os

ON_GPU = os.environ.get("VAMPOMI_TEST_GPU") == "1"

if not ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
    # --xla_cpu_max_isa=AVX2: on jax 0.9.0 + Sapphire-Rapids-class hosts the
    # XLA:CPU AOT loader refuses its OWN persistent-cache entries (its
    # machine check trips on the prefer-no-gather/scatter tuning
    # pseudo-features that AVX512 targeting adds), so every test subprocess
    # recompiled from scratch (~4x suite wall time).  Capping at AVX2 omits
    # those pseudo-features and cache loads work again; the suite is
    # compile-bound, not vector-bound.
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=8 --xla_cpu_max_isa=AVX2"
    )

import jax  # noqa: E402

if not ON_GPU:
    # jax may already have been imported with another platform selected
    # (an interpreter-start hook, a plugin), so the env var alone can be
    # stale by the time pytest runs — override through the live config too
    jax.config.update("jax_platforms", "cpu")

import sys
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parent.parent
if str(REPO_ROOT) not in sys.path:
    sys.path.insert(0, str(REPO_ROOT))

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def small_fixture():
    """Small synthetic (X, beta, y) with known ground truth."""
    from vampomi_tpu.sim.data_sim import simulate_iid

    return simulate_iid(n=300, m=500, lam=0.1, h2=0.8, seed=42)


@pytest.fixture
def gpu():
    """The GPU under test; skips the test where JAX sees none."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs a GPU: run `VAMPOMI_TEST_GPU=1 python -m pytest "
                    "tests -m gpu` on the card")
    return dev


@pytest.fixture(scope="session")
def mesh8():
    import jax
    from vampomi_tpu.sharding import make_mesh

    assert len(jax.devices()) == 8, "conftest failed to force 8 CPU devices"
    return make_mesh()

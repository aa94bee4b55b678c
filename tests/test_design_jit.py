"""Compile options for the jits that read the design matrix
(ops/operator.py design_compile_options, jit_for_design)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vampomi_tpu.ops import operator
from vampomi_tpu.ops.operator import (
    atx, build_design, design_compile_options, jit_for_design,
)

AUTOTUNE_OFF = {"xla_gpu_autotune_level": 0}


@pytest.fixture(scope="module")
def dm():
    rng = np.random.default_rng(0)
    return build_design(rng.normal(size=(64, 24)), compute_dtype=jnp.float32)


def test_cpu_reports_no_limit_so_no_options(dm):
    assert operator._memory_limit(dm.X) == 0
    assert design_compile_options(dm.X) == {}


@pytest.mark.parametrize("limit_per_x, on_mesh, want", [
    (2.0, False, AUTOTUNE_OFF),   # X is half the device: autotuner's copy won't fit
    (3.0, False, {}),             # a third: it fits
    (2.0, True, {}),              # the same X split over 8 devices
])
def test_options_follow_the_shard_share(dm, mesh8, monkeypatch, limit_per_x,
                                        on_mesh, want):
    X = dm.X
    if on_mesh:
        X = build_design(np.asarray(jax.device_get(dm.X)).astype(np.float64),
                         mesh=mesh8, compute_dtype=jnp.float32).X
    monkeypatch.setattr(operator, "_memory_limit",
                        lambda X: int(limit_per_x * dm.X.nbytes))
    assert design_compile_options(X) == want


def test_jit_under_options_matches_the_plain_route(dm, monkeypatch):
    y = jnp.asarray(np.random.default_rng(1).normal(size=24), jnp.float32)
    want = np.asarray(atx(dm, y))
    monkeypatch.setattr(operator, "design_compile_options",
                        lambda X: dict(AUTOTUNE_OFF))
    f = jit_for_design(atx, dm)
    assert f is jit_for_design(atx, dm)  # one wrapper per (fun, options)
    np.testing.assert_allclose(np.asarray(f(dm, y)), want, rtol=1e-6)


def test_jit_of_a_jit_keeps_its_static_arguments(dm):
    @functools.partial(jax.jit, static_argnames=("scale",))
    def scaled_atx(dm, y, scale):
        return scale * atx(dm, y)

    y = jnp.asarray(np.random.default_rng(2).normal(size=24), jnp.float32)
    got = jit_for_design(scaled_atx, dm, ("scale",))(dm, y, scale=3)
    np.testing.assert_allclose(np.asarray(got), 3 * np.asarray(atx(dm, y)),
                               rtol=1e-6)

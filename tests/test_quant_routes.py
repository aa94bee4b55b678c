"""The quantized operator routes (int8 and packed int4) against the exact
f64 product of their codes, on shapes no tile divides; the int4 broadcast
route chunked and unchunked; and the LOO association moments.

The reduce direction (A^T y) is the fused f32 row reduction
(ops/operator.py reduce_rows): exact codes, f32 y, so it meets f32
accumulation error.  The broadcast direction (A x) rounds the weights to
bf16 before a bf16×bf16→f32 product, so it meets bf16 rounding (2^-9).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from vampomi_tpu.ops import operator as op
from vampomi_tpu.ops.operator import (
    PACKED4_DTYPE, atx, atx_batch, ax, ax_batch, build_design,
)

REDUCE_TOL = 2e-6   # f32 accumulation over N terms of exact codes x f32 y
BF16_TOL = 5e-3     # weights rounded to bf16 before the product


def quantized_problem(m, n, dtype, seed=0):
    """A quantized design and the f64 standardized matrix of its codes
    (what the design represents exactly: folding is exact algebra)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(m, n)) * rng.uniform(0.1, 2.0, size=(m, 1)) \
        + rng.uniform(-1, 1, size=(m, 1))
    dm = build_design(X, compute_dtype=dtype)
    if dtype == PACKED4_DTYPE:
        p = np.asarray(dm.X).astype(np.int64)
        codes = np.concatenate([(p & 15) - 8, (p >> 4) - 8], axis=1)
    else:
        codes = np.asarray(dm.X).astype(np.int64)
    mave = np.asarray(dm.mave, dtype=np.float64)
    msig = np.asarray(dm.msig, dtype=np.float64)
    A = (codes - mave[:, None]) * msig[:, None] / np.sqrt(n)  # (M, N)
    return dm, A, rng


def rel(got, ref):
    got = np.asarray(got, dtype=np.float64)
    return np.max(np.abs(got - ref)) / np.max(np.abs(ref))


@pytest.mark.parametrize("m", [512, 509])
@pytest.mark.parametrize("route", ["atx", "ax", "atx_batch", "ax_batch"])
def test_int8_routes_match_exact_product(route, m):
    n = 300
    dm, A, rng = quantized_problem(m, n, jnp.int8, seed=m)
    if route in ("atx", "atx_batch"):
        v = rng.normal(size=(n, 3)).astype(np.float32)
        ref = A @ v.astype(np.float64)
        got = (atx(dm, jnp.asarray(v[:, 0]))[:, None] if route == "atx"
               else atx_batch(dm, jnp.asarray(v)))
        tol = REDUCE_TOL
    else:
        v = rng.normal(size=(m, 3)).astype(np.float32)
        ref = A.T @ v.astype(np.float64)
        got = (ax(dm, jnp.asarray(v[:, 0]))[:, None] if route == "ax"
               else ax_batch(dm, jnp.asarray(v)))
        tol = BF16_TOL
    ref = ref[:, : got.shape[1]]
    assert got.dtype == jnp.float32
    assert rel(got, ref) < tol


@pytest.mark.parametrize("chunked", [False, True], ids=["whole", "chunked"])
@pytest.mark.parametrize("k", [1, 2, 8])
@pytest.mark.parametrize("direction", ["atx", "ax"])
def test_int4_routes_match_dequantized_oracle(direction, k, chunked,
                                              monkeypatch):
    m, n = 500, 200
    dm, A, rng = quantized_problem(m, n, PACKED4_DTYPE, seed=k)
    if chunked:
        # 500 markers in chunks of 256: a ragged final chunk
        monkeypatch.setattr(op, "_UNPACK_CHUNK_BYTES", 65536)
        assert op._packed4_chunk(m, n // 2) == 256
    else:
        assert op._packed4_chunk(m, n // 2) is None
    if direction == "atx":
        v = rng.normal(size=(n, k)).astype(np.float32)
        got = atx_batch(dm, jnp.asarray(v)) if k > 1 else \
            atx(dm, jnp.asarray(v[:, 0]))[:, None]
        assert rel(got, A @ v.astype(np.float64)) < REDUCE_TOL
    else:
        v = rng.normal(size=(m, k)).astype(np.float32)
        got = ax_batch(dm, jnp.asarray(v)) if k > 1 else \
            ax(dm, jnp.asarray(v[:, 0]))[:, None]
        assert rel(got, A.T @ v.astype(np.float64)) < BF16_TOL
    assert got.shape[1] == k


@pytest.mark.parametrize("dtype", [jnp.int8, PACKED4_DTYPE], ids=["int8", "int4"])
def test_loo_stats_match_f64_codes(dtype):
    """Code-space moments and X @ y_mod of the LOO association pass."""
    from vampomi_tpu.modes.association import _loo_stats

    m, n = 300, 200
    dm, _, rng = quantized_problem(m, n, dtype, seed=3)
    if dtype == PACKED4_DTYPE:
        p = np.asarray(dm.X).astype(np.int64)
        codes = np.concatenate([(p & 15) - 8, (p >> 4) - 8], axis=1)
    else:
        codes = np.asarray(dm.X).astype(np.int64)
    y = rng.normal(size=n)
    sumx, sumsqx, xy = map(np.asarray, _loo_stats(dm, jnp.asarray(y, jnp.float32)))
    np.testing.assert_array_equal(sumx, codes.sum(axis=1))
    np.testing.assert_array_equal(sumsqx, (codes * codes).sum(axis=1))
    ref = codes @ y.astype(np.float32).astype(np.float64)
    assert rel(xy, ref) < REDUCE_TOL

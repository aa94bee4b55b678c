"""Work-dtype policy tests: the engine converges in every supported compute
dtype, vectors stay in the work dtype (bf16 X => f32 vectors), and scalar
bookkeeping stays f64 (see ops/operator.py precision policy)."""

import jax.numpy as jnp
import numpy as np
import pytest

from vampomi_tpu.config import RunConfig
from vampomi_tpu.engine.linear import infere_linear
from vampomi_tpu.ops.operator import atx, ax, build_design

PROBS3 = [0.9, 0.07, 0.03]
VARS3 = [0.0, 1e-3, 1e-2]


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16, jnp.int8])
def test_operator_low_precision_close_to_f64(small_fixture, dtype):
    X = small_fixture.X
    dm64 = build_design(X.T, compute_dtype=jnp.float64)
    dmlo = build_design(X.T, compute_dtype=dtype)
    assert dmlo.X.dtype == dtype
    # bf16/int8 X keeps vector math in f32 (work dtype)
    assert dmlo.wd == (jnp.float32 if dtype in (jnp.bfloat16, jnp.int8) else dtype)
    assert dmlo.mave.dtype == dmlo.wd

    rng = np.random.default_rng(0)
    x = rng.normal(size=X.shape[1])
    y = rng.normal(size=X.shape[0])
    tol = 5e-2 if dtype in (jnp.bfloat16, jnp.int8) else 1e-3
    ref_ax = np.asarray(ax(dm64, jnp.asarray(x)))
    lo_ax = np.asarray(ax(dmlo, jnp.asarray(x, dtype=dmlo.wd)), dtype=np.float64)
    assert np.linalg.norm(lo_ax - ref_ax) / np.linalg.norm(ref_ax) < tol
    ref_atx = np.asarray(atx(dm64, jnp.asarray(y)))
    lo_atx = np.asarray(atx(dmlo, jnp.asarray(y, dtype=dmlo.wd)), dtype=np.float64)
    assert np.linalg.norm(lo_atx - ref_atx) / np.linalg.norm(ref_atx) < tol


def test_int8_quantization_roundtrip(small_fixture):
    """Affine codes reproduce the raw values to half a quantization step,
    and the folded standardization vectors make the int8 operator equal the
    f64 operator OF THE DEQUANTIZED MATRIX (folding is exact algebra)."""
    from vampomi_tpu.ops.operator import dequantized_stats, quantize_markers

    X = np.asarray(small_fixture.X.T, dtype=np.float64)  # (M, N) marker-major
    Xq, s, z = quantize_markers(X)
    deq = s[:, None] * Xq.astype(np.float64) + z[:, None]
    assert np.all(np.abs(deq - X) <= 0.5 * s[:, None] + 1e-12)

    # constant marker: zero code, exact reconstruction, unit scale
    Xc = np.vstack([X, np.full((1, X.shape[1]), 0.37)])
    Xqc, sc, zc = quantize_markers(Xc)
    assert np.all(Xqc[-1] == 0) and sc[-1] == 1.0 and zc[-1] == 0.37

    # folded operator == f64 operator of the dequantized matrix (the only
    # remaining error is bf16 rounding of the weight vector + f32 accum)
    dm8 = build_design(X, compute_dtype=jnp.int8)
    mave_d, msig_d = dequantized_stats(Xq, s, z, alpha_scale=1.0)
    A = (deq - mave_d[:, None]) * msig_d[:, None] / np.sqrt(X.shape[1])
    rng = np.random.default_rng(1)
    x = rng.normal(size=X.shape[0])
    got = np.asarray(ax(dm8, jnp.asarray(x, dtype=jnp.float32)), dtype=np.float64)
    want = A.T @ x
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 5e-3
    y = rng.normal(size=X.shape[1])
    got_t = np.asarray(atx(dm8, jnp.asarray(y, dtype=jnp.float32)), dtype=np.float64)
    want_t = A @ y
    assert np.linalg.norm(got_t - want_t) / np.linalg.norm(want_t) < 5e-3

    # dequantized standardization is exact: A rows have zero mean, unit sd
    assert np.abs(A.sum(axis=1)).max() < 1e-9
    sd = A.std(axis=1, ddof=1) * np.sqrt(X.shape[1])
    assert np.abs(sd - 1.0).max() < 1e-9


def test_quantized_design_ignores_raw_stats(small_fixture):
    """Caller-supplied raw-data stats (fused native ingest) must NOT be
    folded into a quantized design: the standardization has to target the
    DEQUANTIZED matrix, else the code matrix carries a quantization-sized
    mean/sd bias (round-3 advisor finding).  The design built with raw
    stats must be bit-identical to one built without."""
    X = np.asarray(small_fixture.X.T, dtype=np.float64)
    n = X.shape[1]
    mave_raw = X.mean(axis=1)
    msig_raw = 1.0 / np.sqrt(((X - mave_raw[:, None]) ** 2).sum(axis=1)
                             / (n - 1.0))
    for dt in (jnp.int8, jnp.uint8):
        dm_plain = build_design(X, compute_dtype=dt)
        dm_stats = build_design(X, compute_dtype=dt,
                                stats=(mave_raw, msig_raw))
        np.testing.assert_array_equal(np.asarray(dm_plain.mave),
                                      np.asarray(dm_stats.mave))
        np.testing.assert_array_equal(np.asarray(dm_plain.msig),
                                      np.asarray(dm_stats.msig))
        np.testing.assert_array_equal(np.asarray(dm_plain.X),
                                      np.asarray(dm_stats.X))
    # ...and a float design still honors the supplied stats verbatim
    dmf = build_design(X, compute_dtype=jnp.float64,
                       stats=(mave_raw, msig_raw))
    np.testing.assert_allclose(np.asarray(dmf.mave)[: X.shape[0]], mave_raw)


def test_int8_gram_close_to_f64(small_fixture):
    from vampomi_tpu.ops.spectral import gram

    X = small_fixture.X
    dm64 = build_design(X.T, compute_dtype=jnp.float64)
    dm8 = build_design(X.T, compute_dtype=jnp.int8)
    K64 = np.asarray(gram(dm64))
    K8 = np.asarray(gram(dm8), dtype=np.float64)
    assert np.linalg.norm(K8 - K64) / np.linalg.norm(K64) < 2e-2


@pytest.mark.parametrize("dtype,solver", [
    (jnp.float32, "cg"),
    (jnp.float32, "spectral"),
    (jnp.bfloat16, "spectral"),
    (jnp.int8, "spectral"),
])
def test_engine_converges_low_precision(small_fixture, tmp_path, dtype, solver):
    """The accelerator's production dtypes recover the signal like the f64
    oracle does."""
    fx = small_fixture
    dm = build_design(fx.X.T, compute_dtype=dtype)
    cfg = RunConfig(
        out_dir=str(tmp_path), out_name="d", iterations=8, rho=0.5, h2=0.8,
        gam1=1e-6, probs=list(PROBS3), vars=list(VARS3),
        stop_criteria_thr=1e-8, seed=7, trace=0, lmmse_solver=solver,
    )
    res = infere_linear(dm, fx.y, cfg, true_signal=fx.beta, write_outputs=False)
    corr = np.corrcoef(res.x1_hat_scaled, fx.beta)[0, 1]
    floor = 0.70 if dtype in (jnp.bfloat16, jnp.int8) else 0.75
    assert corr > floor, f"{dtype} {solver}: corr {corr}"
    assert np.isfinite(res.gamw)

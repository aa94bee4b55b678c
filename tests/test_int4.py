"""Packed int4 design matrix: quantizer bounds, pack/unpack round-trip,
operator parity with the dequantized f64 oracle, Gram/Gibbs equivalence
with an unpacked-codes design, engine convergence, and shard invariance.

The packed layout stores two 4-bit affine codes per byte (low nibble =
sample j, high nibble = sample j + N/2; ops/operator.py PACKED4_DTYPE) —
half the bytes of int8 at the reference's production N=10240
(simulation/sim_top_iid.py:8-30).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from vampomi_tpu.config import RunConfig
from vampomi_tpu.engine.linear import infere_linear
from vampomi_tpu.ops.operator import (
    PACKED4_DTYPE, atx, atx_batch, ax, ax_batch, build_design,
    dequantized_stats, pack_nibbles_host, quantize_markers4, unpack_nibbles,
)

PROBS3 = [0.9, 0.07, 0.03]
VARS3 = [0.0, 1e-3, 1e-2]


def dequantized_A(X_rows):
    """f64 standardized operator of the dequantized matrix — what the
    packed design models exactly (folding is exact algebra)."""
    Xq, s, z = quantize_markers4(X_rows)
    deq = s[:, None] * Xq.astype(np.float64) + z[:, None]
    mave_d, msig_d = dequantized_stats(Xq, s, z, alpha_scale=1.0)
    n = X_rows.shape[1]
    return (deq - mave_d[:, None]) * msig_d[:, None] / np.sqrt(n), Xq, s, z


def test_quantizer_bounds_and_roundtrip(small_fixture):
    X = np.asarray(small_fixture.X.T, dtype=np.float64)
    Xq, s, z = quantize_markers4(X)
    assert Xq.min() >= -8 and Xq.max() <= 7
    deq = s[:, None] * Xq.astype(np.float64) + z[:, None]
    assert np.all(np.abs(deq - X) <= 0.5 * s[:, None] + 1e-12)
    # full-range rows use the full code range
    assert (Xq.min(axis=1) == -8).all() and (Xq.max(axis=1) == 7).all()

    # constant marker: zero codes, exact reconstruction
    Xc = np.vstack([X, np.full((1, X.shape[1]), 0.37)])
    Xqc, sc, zc = quantize_markers4(Xc)
    assert np.all(Xqc[-1] == 0) and sc[-1] == 1.0 and zc[-1] == 0.37

    # pack/unpack round-trip (device unpack vs host codes)
    packed = pack_nibbles_host(Xq)
    assert packed.dtype == np.uint8 and packed.shape == (X.shape[0], X.shape[1] // 2)
    lo, hi = unpack_nibbles(jnp.asarray(packed), dtype=jnp.int8)
    n2 = X.shape[1] // 2
    np.testing.assert_array_equal(np.asarray(lo), Xq[:, :n2])
    np.testing.assert_array_equal(np.asarray(hi), Xq[:, n2:])

    # odd N refuses
    with pytest.raises(ValueError, match="even sample count"):
        pack_nibbles_host(Xq[:, :-1])


def test_operator_matches_dequantized_oracle(small_fixture):
    X = np.asarray(small_fixture.X.T, dtype=np.float64)  # (M, N)
    m, n = X.shape
    dm = build_design(X, compute_dtype=PACKED4_DTYPE)
    assert dm.X.dtype == jnp.uint8 and dm.X.shape == (m, n // 2)
    assert dm.wd == jnp.float32 and int(dm.n) == n
    assert dm.X.shape[1] == n // 2  # two codes per byte

    A, *_ = dequantized_A(X)  # (M, N)
    rng = np.random.default_rng(0)
    x = rng.normal(size=m).astype(np.float32)
    y = rng.normal(size=n).astype(np.float32)

    got_ax = np.asarray(ax(dm, jnp.asarray(x)), dtype=np.float64)
    assert np.linalg.norm(got_ax - A.T @ x) / np.linalg.norm(A.T @ x) < 5e-3
    got_atx = np.asarray(atx(dm, jnp.asarray(y)), dtype=np.float64)
    assert np.linalg.norm(got_atx - A @ y) / np.linalg.norm(A @ y) < 5e-3

    xs = rng.normal(size=(m, 3)).astype(np.float32)
    ys = rng.normal(size=(n, 3)).astype(np.float32)
    zb = np.asarray(ax_batch(dm, jnp.asarray(xs)))
    vb = np.asarray(atx_batch(dm, jnp.asarray(ys)))
    for k in range(3):
        np.testing.assert_allclose(
            zb[:, k], np.asarray(ax(dm, jnp.asarray(xs[:, k]))), rtol=2e-5, atol=2e-5
        )
        np.testing.assert_allclose(
            vb[:, k], np.asarray(atx(dm, jnp.asarray(ys[:, k]))), rtol=2e-5, atol=2e-5
        )

    # dequantized standardization is exact
    assert np.abs(A.sum(axis=1)).max() < 1e-9
    sd = A.std(axis=1, ddof=1) * np.sqrt(n)
    assert np.abs(sd - 1.0).max() < 1e-9


def test_gram_and_gibbs_match_unpacked_codes(small_fixture):
    """The packed design and an int8 design holding the SAME unpacked codes
    (same folded vectors) must produce near-identical Grams — packing is
    pure storage, not math."""
    from vampomi_tpu.gibbs.sampler import build_block_grams
    from vampomi_tpu.ops.spectral import gram

    X = np.asarray(small_fixture.X.T, dtype=np.float64)
    dm4 = build_design(X, compute_dtype=PACKED4_DTYPE)
    Xq, s, z = quantize_markers4(X)
    dm8 = dm4._replace(X=jnp.asarray(Xq))  # same vectors, unpacked storage

    K4 = np.asarray(gram(dm4), dtype=np.float64)
    K8 = np.asarray(gram(dm8), dtype=np.float64)
    np.testing.assert_allclose(K4, K8, rtol=1e-5, atol=1e-6)

    # f64 oracle of the dequantized matrix (A rows are markers; the
    # operator's Gram K = A_op A_op^T is (N, N) = A^T A here)
    A, *_ = dequantized_A(X)
    K_true = A.T @ A
    assert np.linalg.norm(K4 - K_true) / np.linalg.norm(K_true) < 2e-2

    # Gibbs block Grams: both take the int8-exact route -> exact match
    m = X.shape[0]
    mb = (m // 4) * 4
    g4 = np.asarray(build_block_grams(
        dm4._replace(X=dm4.X[:mb], mave=dm4.mave[:mb], msig=dm4.msig[:mb],
                     mmask=dm4.mmask[:mb]), block=mb // 4))
    g8 = np.asarray(build_block_grams(
        dm8._replace(X=dm8.X[:mb], mave=dm8.mave[:mb], msig=dm8.msig[:mb],
                     mmask=dm8.mmask[:mb]), block=mb // 4))
    np.testing.assert_array_equal(g4, g8)


def test_shard_invariance_packed4(small_fixture, mesh8):
    X = small_fixture.X  # M=500 -> pad to 504
    dm1 = build_design(X.T, mesh=None, compute_dtype=PACKED4_DTYPE)
    dm8 = build_design(X.T, mesh=mesh8, compute_dtype=PACKED4_DTYPE)
    assert dm8.m_pad % 8 == 0 and dm8.X.shape[1] == X.shape[0] // 2

    rng = np.random.default_rng(5)
    x = rng.normal(size=X.shape[1]).astype(np.float32)
    xp = np.zeros(dm8.m_pad, dtype=np.float32)
    xp[: X.shape[1]] = x
    z1 = np.asarray(ax(dm1, jnp.asarray(np.pad(x, (0, dm1.m_pad - X.shape[1])))))
    z8 = np.asarray(ax(dm8, jnp.asarray(xp)))
    np.testing.assert_allclose(z8, z1, rtol=1e-5, atol=1e-5)

    y = rng.normal(size=X.shape[0]).astype(np.float32)
    v1 = np.asarray(atx(dm1, jnp.asarray(y)))
    v8 = np.asarray(atx(dm8, jnp.asarray(y)))
    np.testing.assert_allclose(v8[: X.shape[1]], v1[: X.shape[1]], rtol=1e-5, atol=1e-5)
    assert np.all(v8[X.shape[1]:] == 0.0), "padded entries must be exact zeros"


@pytest.mark.parametrize("solver", ["spectral", "cg"])
def test_engine_converges_int4(small_fixture, tmp_path, solver):
    fx = small_fixture
    dm = build_design(fx.X.T, compute_dtype=PACKED4_DTYPE)
    cfg = RunConfig(
        out_dir=str(tmp_path), out_name="q4", iterations=8, rho=0.5, h2=0.8,
        gam1=1e-6, probs=list(PROBS3), vars=list(VARS3),
        stop_criteria_thr=1e-8, seed=7, trace=0, lmmse_solver=solver,
    )
    res = infere_linear(dm, fx.y, cfg, true_signal=fx.beta, write_outputs=False)
    corr = np.corrcoef(res.x1_hat_scaled, fx.beta)[0, 1]
    assert corr > 0.65, f"int4 {solver}: corr {corr}"
    assert np.isfinite(res.gamw)


def test_chunked_unpack_fallback_matches_unchunked(small_fixture, monkeypatch):
    """The marker-chunked unpack route (operator._packed4_ax_chunked: no
    full-M bf16 transient) must reproduce the single-shot unpack-einsum
    results, including a ragged final chunk (M=500 with chunk=256 ->
    256 + 244)."""
    from vampomi_tpu.ops import operator as op

    X = small_fixture.X  # (N=200, M=500)
    dm = build_design(X.T, compute_dtype=PACKED4_DTYPE)
    rng = np.random.default_rng(13)
    x = jnp.asarray(rng.normal(size=dm.m_pad).astype(np.float32))
    xs = jnp.asarray(rng.normal(size=(dm.m_pad, 3)).astype(np.float32))
    y = jnp.asarray(rng.normal(size=X.shape[0]).astype(np.float32))
    ys = jnp.asarray(rng.normal(size=(X.shape[0], 3)).astype(np.float32))

    assert op._packed4_chunk(dm.X.shape[0], dm.X.shape[1]) is None
    ref = [np.asarray(f(dm, v)) for f, v in
           ((ax, x), (atx, y), (ax_batch, xs), (atx_batch, ys))]

    monkeypatch.setattr(op, "_UNPACK_CHUNK_BYTES", 65536)
    chunk = op._packed4_chunk(dm.X.shape[0], dm.X.shape[1])
    assert chunk == 256 and dm.X.shape[0] % chunk != 0  # ragged tail
    got = [np.asarray(f(dm, v)) for f, v in
           ((ax, x), (atx, y), (ax_batch, xs), (atx_batch, ys))]

    for r, g in zip(ref, got):
        np.testing.assert_allclose(g, r, rtol=2e-5, atol=2e-5)

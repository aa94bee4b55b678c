"""Tests for the once-per-dataset eigendecomposition of the Gram matrix
(ops/eigen.py) and the eigen-LMMSE solve/trace identities.

The CPU oracle path runs the identical sign-D&C algorithm in f64 and is
locked against numpy's eigh; the f32 case bounds the working-precision
error the accelerator's f32 path will see."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vampomi_tpu.ops.eigen import (
    EigenFactor, build_eigen, eigen_solve, eigen_traces,
)
from vampomi_tpu.ops.operator import build_design
from vampomi_tpu.ops.spectral import GramFactor, build_spectral


def _gram(n, m, seed, dtype=jnp.float64, corr=0.0):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n))
    if corr > 0:
        # correlated samples: a few strong factors widen the spectrum the
        # way real (non-iid) methylation data does
        F = rng.standard_normal((m, 4))
        L = rng.standard_normal((4, n))
        A = A + corr * (F @ L)
    K = (A.T @ A) / m
    return GramFactor(K=jnp.asarray(0.5 * (K + K.T), dtype=dtype))


@pytest.mark.parametrize("corr", [0.0, 3.0])
def test_build_eigen_f64_matches_numpy(corr):
    fac = _gram(n=384, m=1536, seed=0, corr=corr)
    ef, diag = build_eigen(fac, leaf=64)
    lam_np = np.linalg.eigvalsh(np.asarray(fac.K))
    lam = np.asarray(ef.lam)
    assert lam.shape == (384,)
    scale = np.abs(lam_np).max()
    assert np.max(np.abs(np.sort(lam) - lam_np)) / scale < 1e-9
    assert diag["resid"] < 1e-9
    assert diag["ortho"] < 1e-10
    assert diag["splits"] >= 2  # leaf=64 must actually exercise the D&C
    # U diagonalizes K
    U = np.asarray(ef.U)
    H = U.T @ np.asarray(fac.K) @ U
    assert np.max(np.abs(H - np.diag(lam))) / scale < 1e-9


def test_build_eigen_degenerate_cluster_on_mean():
    """Adversarial spectrum: a large EXACTLY-degenerate cluster sitting on
    the trace-mean split point.  The sign iteration leaves those modes at 0
    with an INTEGER trace, so only the ||X||_F^2 zero-mode count
    (_sign_finish) can detect it; without the nudge both children extract
    independent random subspaces of the cluster's eigenspace that overlap
    instead of complementing (measured resid 0.056, ortho 0.37)."""
    rng = np.random.default_rng(0)
    n = 288
    vals = np.concatenate(
        [np.full(96, 0.5), np.full(96, 1.0), np.full(96, 1.5)])
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    K = (Q * vals) @ Q.T
    fac = GramFactor(K=jnp.asarray(0.5 * (K + K.T)))
    ef, diag = build_eigen(fac, leaf=64)
    assert diag["resid"] < 1e-9
    assert diag["ortho"] < 1e-10
    lam = np.sort(np.asarray(ef.lam))
    assert np.max(np.abs(lam - np.sort(vals))) < 1e-9


@pytest.mark.parametrize("name", ["zeros30", "pairs1e-12", "outliers"])
def test_build_eigen_spectrum_zoo(name):
    """Adversarial spectra beyond the Wishart fixtures: a rank-deficient
    Gram (constant markers -> exact zero cluster), near-degenerate pairs
    split by 1e-12, and a 5-decade outlier tail over a tight bulk."""
    rng = np.random.default_rng(0)
    if name == "zeros30":
        vals = np.concatenate(
            [np.zeros(96), np.abs(rng.standard_normal(224)) + 0.1])
    elif name == "pairs1e-12":
        base = np.sort(np.abs(rng.standard_normal(160))) + 0.5
        vals = np.sort(np.concatenate([base, base + 1e-12]))
    else:
        vals = np.concatenate(
            [np.full(310, 1.0) + 1e-3 * rng.standard_normal(310),
             [50.0, 120.0, 300.0, 1e4, 2e4, 1e5, 1e6, 5e6, 1e7, 2e7]])
    n = len(vals)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    K = (Q * vals) @ Q.T
    ef, diag = build_eigen(GramFactor(K=jnp.asarray(0.5 * (K + K.T))),
                           leaf=64)
    assert diag["resid"] < 1e-9
    assert diag["ortho"] < 1e-10
    lam = np.sort(np.asarray(ef.lam))
    scale = np.abs(vals).max()
    assert np.max(np.abs(lam - np.sort(vals))) / scale < 1e-12


def test_build_eigen_f32_mp_narrow():
    """The production regime: M >> N gives the tight Marchenko-Pastur bulk
    (tiny spectral gaps) — the hard case for the sign splits."""
    fac = _gram(n=256, m=8192, seed=1, dtype=jnp.float32)
    ef, diag = build_eigen(fac, leaf=64)
    assert diag["resid"] < 5e-5
    assert diag["ortho"] < 1e-4
    lam_np = np.linalg.eigvalsh(np.asarray(fac.K, dtype=np.float64))
    lam = np.sort(np.asarray(ef.lam))
    assert np.max(np.abs(lam - lam_np)) / np.abs(lam_np).max() < 1e-4


def test_eigen_solve_and_traces_exact_f64(small_fixture):
    fx = small_fixture
    dm = build_design(fx.X.T, compute_dtype=jnp.float64)
    fac = build_spectral(dm)
    ef, diag = build_eigen(fac, leaf=64)
    assert diag["resid"] < 1e-9

    n = fac.n
    mt = float(dm.mt)
    rng = np.random.default_rng(3)
    v = rng.standard_normal(dm.m_pad)
    tau, gam2 = 7.3, 0.42

    # direct dense oracle in numpy f64
    K = np.asarray(fac.K)
    S = gam2 * np.eye(n) + tau * K
    Sinv = np.linalg.inv(S)

    mu, q = eigen_solve(dm, ef, jnp.asarray(v), tau, gam2)
    # q = S^{-1} A v
    from vampomi_tpu.ops.operator import ax as _ax, normal_eq_mult

    av = np.asarray(_ax(dm, jnp.asarray(v)))
    np.testing.assert_allclose(np.asarray(q), Sinv @ av, rtol=0, atol=1e-9)
    # mu solves the normal equations
    lhs = np.asarray(normal_eq_mult(dm, mu, tau, gam2))
    np.testing.assert_allclose(lhs, v, rtol=0, atol=1e-8)

    tr_qinv, tr_ata = eigen_traces(ef, mt, tau, gam2)
    lam_np = np.linalg.eigvalsh(K)
    T = np.sum(1.0 / (gam2 + tau * lam_np))
    assert abs(float(tr_qinv) - (T + (mt - n) / gam2)) / abs(T) < 1e-10
    assert abs(float(tr_ata) - (n - gam2 * T) / tau) / n < 1e-10


def test_eigen_solve_matches_spectral_winv(small_fixture):
    """The eigen path and the per-iteration factor path are the same
    mathematical operator — lock them against each other."""
    from vampomi_tpu.ops.spectral import shift_inverse, spectral_solve, spectral_traces

    fx = small_fixture
    dm = build_design(fx.X.T, compute_dtype=jnp.float64)
    fac = build_spectral(dm)
    ef, _ = build_eigen(fac, leaf=64)

    rng = np.random.default_rng(4)
    v = jnp.asarray(rng.standard_normal(dm.m_pad))
    tau, gam2 = 2.0, 1.3
    winv = shift_inverse(fac, tau, gam2)
    mu_s, q_s = spectral_solve(dm, fac, v, tau, gam2, winv=winv)
    mu_e, q_e = eigen_solve(dm, ef, v, tau, gam2)
    np.testing.assert_allclose(np.asarray(mu_e), np.asarray(mu_s), atol=1e-9)
    np.testing.assert_allclose(np.asarray(q_e), np.asarray(q_s), atol=1e-9)

    t_s = spectral_traces(fac, dm.mt, tau, gam2, winv=winv)
    t_e = eigen_traces(ef, dm.mt, tau, gam2)
    assert abs(float(t_s[0]) - float(t_e[0])) / abs(float(t_s[0])) < 1e-10
    assert abs(float(t_s[1]) - float(t_e[1])) / abs(float(t_s[1])) < 1e-10


PROBS3 = [0.9, 0.07, 0.03]
VARS3 = [0.0, 1e-3, 1e-2]


def test_engine_eigen_matches_spectral_trajectory(small_fixture, tmp_path):
    """The eigen engine is the SAME exact algorithm as the spectral engine —
    f64 trajectories must agree to solver roundoff, iteration by iteration."""
    from vampomi_tpu.config import RunConfig
    from vampomi_tpu.engine.linear import infere_linear

    fx = small_fixture
    dm = build_design(fx.X.T, compute_dtype=jnp.float64)
    common = dict(
        out_dir=str(tmp_path), out_name="e", iterations=6, rho=0.5, h2=0.8,
        gam1=1e-6, probs=list(PROBS3), vars=list(VARS3),
        stop_criteria_thr=1e-10, seed=7, trace=0,
    )
    res_e = infere_linear(dm, fx.y, RunConfig(lmmse_solver="eigen", **common),
                          true_signal=fx.beta, write_outputs=False)
    res_s = infere_linear(dm, fx.y, RunConfig(lmmse_solver="spectral", **common),
                          true_signal=fx.beta, write_outputs=False)
    assert res_e.iterations_run == res_s.iterations_run
    for me, ms in zip(res_e.metrics_history, res_s.metrics_history):
        np.testing.assert_allclose(me, ms, rtol=0, atol=1e-8)
    np.testing.assert_allclose(res_e.x1_hat_scaled, res_s.x1_hat_scaled, atol=1e-9)
    assert abs(res_e.gamw - res_s.gamw) / res_s.gamw < 1e-8


def test_engine_eigen_shard_invariance(tmp_path, mesh8):
    """Eigen engine on the 8-device mesh reproduces the single-device run.

    N = 320 divides the mesh, so build_eigen SHARDS the eigenbasis columns
    over the marker axis — this exercises the distributed per-iteration
    dense path (sharded U^T av contraction + one N-vector psum), the
    design that removes the replicated-dense Amdahl term (SCALING.md)."""
    from jax.sharding import NamedSharding
    from vampomi_tpu.config import RunConfig
    from vampomi_tpu.engine.linear import infere_linear
    from vampomi_tpu.ops.eigen import build_eigen
    from vampomi_tpu.sim.data_sim import simulate_iid

    fx = simulate_iid(n=320, m=1280, lam=0.05, h2=0.8, seed=12)
    common = dict(
        out_dir=str(tmp_path), out_name="em", iterations=4, rho=0.5, h2=0.8,
        gam1=1e-6, probs=list(PROBS3), vars=list(VARS3),
        stop_criteria_thr=1e-10, seed=7, trace=0, lmmse_solver="eigen",
    )
    dm1 = build_design(fx.X.T, mesh=None, compute_dtype=jnp.float64)
    dm8 = build_design(fx.X.T, mesh=mesh8, compute_dtype=jnp.float64)
    # the mesh build must actually shard the eigenbasis columns
    ef8, _ = build_eigen(build_spectral(dm8), leaf=64)
    assert isinstance(ef8.U.sharding, NamedSharding)
    assert ef8.U.sharding.spec[1] is not None

    r1 = infere_linear(dm1, fx.y, RunConfig(**common),
                       true_signal=fx.beta, write_outputs=False)
    r8 = infere_linear(dm8, fx.y, RunConfig(**common),
                       true_signal=fx.beta, write_outputs=False)
    np.testing.assert_allclose(r8.x1_hat_scaled, r1.x1_hat_scaled, atol=1e-9)


def test_probit_eigen_matches_spectral(tmp_path):
    """Probit GLM-VAMP with the eigen solver reproduces the spectral-solver
    trajectory (tau2 moves every iteration; the eigenbasis is
    shift-invariant)."""
    from vampomi_tpu.config import RunConfig
    from vampomi_tpu.engine.probit import infere_bin_class
    from vampomi_tpu.sim.data_sim import simulate_iid

    fx = simulate_iid(n=400, m=300, lam=0.15, h2=0.9, seed=9)
    rng = np.random.default_rng(10)
    ybin = (fx.X @ fx.beta + rng.normal(0, np.sqrt(0.1), fx.X.shape[0]) > 0
            ).astype(float)
    dm = build_design(fx.X.T, mesh=None, compute_dtype=jnp.float64)
    common = dict(
        out_dir=str(tmp_path), out_name="pe", model="bin_class", iterations=5,
        rho=0.3, gam1=1e-2, probs=[0.85, 0.1, 0.05], vars=[0.0, 1e-3, 1e-2],
        stop_criteria_thr=1e-10, seed=3, trace=0,
    )
    r_e = infere_bin_class(dm, ybin, RunConfig(lmmse_solver="eigen", **common),
                           true_signal=fx.beta, write_outputs=False)
    r_s = infere_bin_class(dm, ybin, RunConfig(lmmse_solver="spectral", **common),
                           true_signal=fx.beta, write_outputs=False)
    np.testing.assert_allclose(r_e.x1_hat_scaled, r_s.x1_hat_scaled, atol=1e-9)
    for me, ms in zip(r_e.metrics_history, r_s.metrics_history):
        np.testing.assert_allclose(me, ms, rtol=0, atol=1e-8)


def test_eigen_cache_roundtrip(tmp_path):
    """build_eigen_cached: first call builds and persists, second call
    loads the identical factor, and a cache written for a DIFFERENT
    dataset is detected (trace mismatch) and rebuilt, not silently used."""
    from vampomi_tpu.ops.eigen import build_eigen_cached

    path = str(tmp_path / "eig.npz")
    fac = _gram(n=192, m=768, seed=6)
    ef1, d1 = build_eigen_cached(fac, path, leaf=64)
    assert not d1.get("loaded") and (tmp_path / "eig.npz").exists()

    ef2, d2 = build_eigen_cached(fac, path, leaf=64)
    assert d2["loaded"] and d2["resid"] == d1["resid"]
    np.testing.assert_array_equal(np.asarray(ef2.U), np.asarray(ef1.U))
    np.testing.assert_array_equal(np.asarray(ef2.lam), np.asarray(ef1.lam))

    other = _gram(n=192, m=768, seed=7)
    ef3, d3 = build_eigen_cached(other, path, leaf=64)
    assert not d3.get("loaded")  # stale cache rejected, rebuilt
    lam_np = np.linalg.eigvalsh(np.asarray(other.K))
    scale = np.abs(lam_np).max()
    assert np.max(np.abs(np.sort(np.asarray(ef3.lam)) - lam_np)) / scale < 1e-9
    # and the overwritten cache now loads for the NEW dataset
    ef4, d4 = build_eigen_cached(other, path, leaf=64)
    assert d4["loaded"]

    # a different build seed must rebuild (the cached-factor contract is
    # "deterministic for a given (K, seed)")
    _, d5 = build_eigen_cached(other, path, leaf=64, seed=3)
    assert not d5.get("loaded")

    # corrupt/truncated caches are a miss, never a crash
    with open(path, "wb") as f:
        f.write(b"not an npz")
    _, d6 = build_eigen_cached(other, path, leaf=64, seed=3)
    assert not d6.get("loaded")
    _, d7 = build_eigen_cached(other, path, leaf=64, seed=3)
    assert d7["loaded"]  # the rebuild overwrote the corrupt file


def test_eigen_cache_rejects_stale_at_production_ratio(tmp_path):
    """The fingerprint must discriminate datasets in the wide-M regime:
    trace(K) ~ N is identical for ANY two standardized same-shape Grams,
    so a combined trace+sketch norm test is swamped by the trace at
    production M/N (verified falsely accepting at M/N >= 128) — trace and
    sketch are compared separately."""
    from vampomi_tpu.ops.eigen import build_eigen_cached

    path = str(tmp_path / "eig.npz")
    n, m = 64, 16384  # M/N = 256, beyond the observed false-accept ratio
    ef1, d1 = build_eigen_cached(_gram(n, m, seed=1), path, leaf=64)
    _, d2 = build_eigen_cached(_gram(n, m, seed=2), path, leaf=64)
    assert not d2.get("loaded")  # different dataset, same shape: rejected


def test_build_eigen_compile_census():
    """Lock the dispatch-fusion design: every device op in build_eigen comes
    from the module's small closed set of jitted kernels, and shape
    quantization keeps each kernel's compile-cache population bounded by the
    number of distinct quantized block widths — NOT by the number of
    recursion nodes.  (Each extra cached entry is a compile; an eager-glue
    formulation needed ~1500 of them.)"""
    import vampomi_tpu.ops.eigen as eig

    jax.clear_caches()
    fac = _gram(n=384, m=1536, seed=5)
    _, diag = build_eigen(fac, leaf=64)
    assert diag["splits"] >= 4  # the tree must actually recurse

    kernels = {
        name: fn for name, fn in vars(eig).items()
        if callable(fn) and hasattr(fn, "_cache_size")
    }
    assert len(kernels) >= 10  # the closed kernel set exists
    sizes = {name: fn._cache_size() for name, fn in kernels.items()}
    total = sum(sizes.values())
    # n=384 / quant=64 allows <= 6 distinct block widths; kernels keyed by
    # (r, kq) pairs may see a few combinations each.  A per-node shape leak
    # would push individual kernels past the split count instead.
    assert total <= 60, sizes
    for name, s in sizes.items():
        assert s <= 14, (name, sizes)


def test_auto_solver_upgrades_to_eigen_on_mesh(tmp_path):
    """Auto upgrades to eigen only on a WARM cache — single-chip AND
    multi-chip alike (round-3 review Weak #2: a cold mesh run must not pay
    the ~20-min remote-compile eigen build before iteration 1)."""
    from vampomi_tpu.config import RunConfig
    from vampomi_tpu.engine.linear import choose_lmmse_solver

    cfg = RunConfig()
    assert choose_lmmse_solver(cfg, mt=1_000_000, n=10_000, n_devices=1) == "spectral"
    assert choose_lmmse_solver(cfg, mt=1_000_000, n=10_000, n_devices=8) == "spectral"
    assert choose_lmmse_solver(cfg, mt=2000, n=300, n_devices=8) == "cg"
    # a warm cache upgrades the mesh path exactly like single-chip
    mcache = tmp_path / "mesh_eig.npz"
    np.savez(mcache, n=10_000)
    cfg_m = RunConfig(eigen_cache=str(mcache))
    assert choose_lmmse_solver(cfg_m, mt=1_000_000, n=10_000, n_devices=8) == "eigen"

    # a warm cache upgrades single-chip auto; absent, corrupt, or
    # wrong-N files must NOT (the upgrade's premise is a free build)
    cache = tmp_path / "eig.npz"
    cfg_c = RunConfig(eigen_cache=str(cache))
    assert choose_lmmse_solver(cfg_c, mt=1_000_000, n=10_000, n_devices=1) == "spectral"
    cache.write_bytes(b"")  # corrupt (empty) file
    assert choose_lmmse_solver(cfg_c, mt=1_000_000, n=10_000, n_devices=1) == "spectral"
    np.savez(cache, n=9_999)  # wrong N
    assert choose_lmmse_solver(cfg_c, mt=1_000_000, n=10_000, n_devices=1) == "spectral"
    np.savez(cache, n=10_000)
    assert choose_lmmse_solver(cfg_c, mt=1_000_000, n=10_000, n_devices=1) == "eigen"


def test_engine_eigen_build_budget_falls_back(small_fixture, capsys):
    """--eigen-build-budget: an engine run whose eigen build overruns the
    wall budget must complete on the spectral path with finite (and
    identical-algorithm) results instead of hanging for the build."""
    from vampomi_tpu.config import RunConfig
    from vampomi_tpu.engine.linear import infere_linear

    fx = small_fixture
    dm = build_design(fx.X.T, mesh=None, compute_dtype=jnp.float64)
    cfg = RunConfig(
        out_dir="/tmp", out_name="budget_t", iterations=3, meth_file="x",
        probs=[0.9, 0.07, 0.03], vars=[0.0, 1e-3, 1e-2], h2=0.8,
        learn_prior_delay=99, stop_criteria_thr=0.0,
        lmmse_solver="eigen", eigen_build_budget=1e-9, verbosity=1,
    )
    res = infere_linear(dm, fx.y, cfg, true_signal=fx.beta,
                        write_outputs=False)
    assert res.iterations_run == 3
    assert np.all(np.isfinite(res.x1_hat_scaled))
    assert "--eigen-build-budget" in capsys.readouterr().out

    # the same run with the budget off runs eigen and matches the spectral
    # trajectory (same exact algorithm, different dense representation)
    res_e = infere_linear(dm, fx.y, cfg.replace(eigen_build_budget=0.0),
                          true_signal=fx.beta, write_outputs=False)
    np.testing.assert_allclose(res_e.x1_hat_scaled, res.x1_hat_scaled,
                               atol=1e-8)

"""Linear engine tests: trajectory lock against the numpy oracle, end-to-end
signal recovery, output artifacts, warm start, and shard invariance."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vampomi_tpu.config import RunConfig
from vampomi_tpu.engine.linear import infere_linear
from vampomi_tpu.io.bin_io import read_bin_slab
from vampomi_tpu.io.csv_writer import read_positional_csv
from vampomi_tpu.ops.operator import build_design

from tests.reference_impl import NumpyVampOracle, engine_probes

PROBS3 = [0.9, 0.07, 0.03]
VARS3 = [0.0, 1e-3, 1e-2]


def base_cfg(tmp, **kw):
    d = dict(
        out_dir=str(tmp), out_name="t", iterations=3, rho=0.5, h2=0.8,
        gam1=1e-6, probs=list(PROBS3), vars=list(VARS3),
        CG_max_iter=500, CG_err_tol=1e-5, EM_max_iter=1, EM_err_thr=1e-2,
        learn_vars=1, learn_prior_delay=1, merge_vars_thr=0.5,
        stop_criteria_thr=1e-8, seed=7,
    )
    d.update(kw)
    return RunConfig(**d)


@pytest.fixture(scope="module")
def traj(small_fixture, tmp_path_factory):
    """Run engine and oracle on identical inputs + probes."""
    fx = small_fixture
    tmp = tmp_path_factory.mktemp("lin")
    cfg = base_cfg(tmp, iterations=4)

    dm = build_design(fx.X.T, mesh=None, compute_dtype=jnp.float64)
    res = infere_linear(dm, fx.y, cfg, true_signal=fx.beta, write_outputs=True)

    probes = engine_probes(cfg.seed, cfg.iterations, dm.m_pad, fx.X.shape[1])
    oracle = NumpyVampOracle(
        fx.X, fx.y, PROBS3, VARS3, gam1=cfg.gam1, h2=cfg.h2, rho=cfg.rho,
        cg_max_iter=cfg.CG_max_iter, cg_err_tol=cfg.CG_err_tol,
        em_max_iter=cfg.EM_max_iter, em_err_thr=cfg.EM_err_thr,
        learn_vars=cfg.learn_vars, learn_prior_delay=cfg.learn_prior_delay,
        merge_vars_thr=cfg.merge_vars_thr, stop_criteria_thr=cfg.stop_criteria_thr,
    )
    hist = oracle.run(cfg.iterations, probes)
    return fx, cfg, tmp, res, hist


def test_trajectory_matches_oracle(traj):
    fx, cfg, tmp, res, hist = traj
    params = read_positional_csv(os.path.join(tmp, "t_params.csv"))
    assert len(params) == len(hist)
    for row, h in zip(params, hist):
        it, alpha1, gam1_pre, alpha2, gam2, gamw = row
        assert int(it) == h["it"]
        np.testing.assert_allclose(alpha1, h["alpha1"], rtol=1e-6)
        np.testing.assert_allclose(gam1_pre, h["gam1_pre"], rtol=1e-6)
        np.testing.assert_allclose(alpha2, h["alpha2"], rtol=1e-4)
        np.testing.assert_allclose(gam2, h["gam2"], rtol=1e-5)
        np.testing.assert_allclose(gamw, h["gamw"], rtol=1e-4)


def test_iteration_artifacts_match_oracle(traj):
    fx, cfg, tmp, res, hist = traj
    n = fx.X.shape[0]
    for h in hist:
        it = h["it"]
        x1 = read_bin_slab(os.path.join(tmp, f"t_it_{it}.bin"), fx.X.shape[1])
        np.testing.assert_allclose(x1, h["x1_hat"] / np.sqrt(n), rtol=1e-4, atol=1e-12)
    # r1 dump of iteration k equals oracle's r1 entering iteration k
    r1_2 = read_bin_slab(os.path.join(tmp, "t_r1_it_2.bin"), fx.X.shape[1])
    np.testing.assert_allclose(r1_2, hist[0]["r1"] / np.sqrt(n), rtol=1e-4, atol=1e-12)


def test_prior_trajectory_matches_oracle(traj):
    fx, cfg, tmp, res, hist = traj
    n = fx.X.shape[0]
    final = hist[-1]
    # oracle vars are internal (×N); engine result too
    np.testing.assert_allclose(
        np.sort(res.probs), np.sort(final["probs"]), rtol=1e-5
    )
    np.testing.assert_allclose(
        np.sort(res.vars), np.sort(final["vars"]), rtol=1e-4
    )


def test_end_to_end_recovery(small_fixture, tmp_path):
    """The headline behavior: gVAMP recovers the sparse signal."""
    fx = small_fixture
    cfg = base_cfg(tmp_path, iterations=20, stop_criteria_thr=1e-3)
    dm = build_design(fx.X.T, mesh=None, compute_dtype=jnp.float64)
    res = infere_linear(dm, fx.y, cfg, true_signal=fx.beta, write_outputs=False)
    corr = np.corrcoef(res.x1_hat_scaled, fx.beta)[0, 1]
    assert corr > 0.85, f"signal recovery corr {corr}"
    # learned noise precision should imply h2 = 1 - 1/gamw near the true 0.8
    h2_est = 1.0 - 1.0 / res.gamw
    assert 0.6 < h2_est < 0.95, f"h2 estimate {h2_est}"


def test_shard_invariance(small_fixture, tmp_path, mesh8):
    """8-device mesh run must match the single-device run (rank-count
    invariance, the reference's implicit multi-node correctness contract)."""
    fx = small_fixture
    cfg = base_cfg(tmp_path, iterations=3)
    dm1 = build_design(fx.X.T, mesh=None, compute_dtype=jnp.float64)
    dm8 = build_design(fx.X.T, mesh=mesh8, compute_dtype=jnp.float64)
    r1 = infere_linear(dm1, fx.y, cfg, true_signal=fx.beta, write_outputs=False)
    r8 = infere_linear(dm8, fx.y, cfg, true_signal=fx.beta, write_outputs=False)
    np.testing.assert_allclose(r8.x1_hat_scaled, r1.x1_hat_scaled, rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(r8.gamw, r1.gamw, rtol=1e-8)


def test_warm_start_changes_init(small_fixture, tmp_path):
    fx = small_fixture
    cfg = base_cfg(tmp_path, iterations=1, gam1=1.0)
    dm = build_design(fx.X.T, mesh=None, compute_dtype=jnp.float64)
    cold = infere_linear(dm, fx.y, cfg, true_signal=fx.beta, write_outputs=False)
    warm = infere_linear(
        dm, fx.y, cfg, true_signal=fx.beta, x1hat_init=fx.beta * np.sqrt(fx.X.shape[0]),
        write_outputs=False,
    )
    assert not np.allclose(cold.x1_hat_scaled, warm.x1_hat_scaled)


def test_stopping_criterion(small_fixture, tmp_path):
    fx = small_fixture
    cfg = base_cfg(tmp_path, iterations=30, stop_criteria_thr=0.05)
    dm = build_design(fx.X.T, mesh=None, compute_dtype=jnp.float64)
    res = infere_linear(dm, fx.y, cfg, true_signal=fx.beta, write_outputs=False)
    assert res.iterations_run < 30


def test_linear_covariate_path(small_fixture, tmp_path):
    """Linear-mode covariates: the reference fits them with the PROBIT Newton
    solver on the continuous phenotype and subtracts Z @ cov_eff once
    (src/vamp.cpp:153-169 -> Newton_method_cov) — a reference quirk mirrored
    for parity. Verify the path runs and still recovers signal."""
    fx = small_fixture
    rng = np.random.default_rng(3)
    n = fx.X.shape[0]
    Z = rng.normal(size=(n, 2))
    dm = build_design(fx.X.T, mesh=None, compute_dtype=jnp.float64)
    cfg = base_cfg(tmp_path, iterations=6, C=2, out_name="cov")
    res = infere_linear(dm, fx.y, cfg, true_signal=fx.beta,
                        covariates=Z, write_outputs=False)
    assert np.all(np.isfinite(res.x1_hat_scaled))
    corr = np.corrcoef(res.x1_hat_scaled, fx.beta)[0, 1]
    assert corr > 0.7, corr


def test_verbosity_compiles_in_residual_prints(small_fixture, tmp_path, capfd):
    """--verbosity 1 emits the reference's per-CG and per-EM residual
    narration (src/vamp.cpp:615-617, 723-724, 747-748); default stays quiet."""
    fx = small_fixture
    dm = build_design(fx.X.T, mesh=None, compute_dtype=jnp.float64)
    cfg = base_cfg(tmp_path, iterations=2, verbosity=1)
    infere_linear(dm, fx.y, cfg, true_signal=fx.beta, write_outputs=False)
    jax.effects_barrier()  # flush jax.debug.print callbacks
    out = capfd.readouterr().out
    assert "[CG] it = " in out and "||r_it|| / ||RHS||" in out
    assert "dist_probs = " in out and "dist_vars = " in out

    cfg0 = base_cfg(tmp_path, iterations=2, verbosity=0)
    infere_linear(dm, fx.y, cfg0, true_signal=fx.beta, write_outputs=False)
    jax.effects_barrier()
    out0 = capfd.readouterr().out
    assert "[CG] it = " not in out0 and "dist_probs" not in out0


@pytest.mark.parametrize("solver", ["spectral", "cg"])
def test_unsharded_run_compiles_each_phase_once(small_fixture, solver,
                                                tmp_path, caplog):
    """Off a mesh the loop's scalars start as strong f64 device values, so
    iteration 2 (fed the phases' own outputs) reuses iteration 1's
    executables: one compile per phase for the whole run."""
    import logging

    fx = small_fixture
    dm = build_design(fx.X.T, mesh=None, compute_dtype=jnp.float32)
    cfg = base_cfg(tmp_path, iterations=3, lmmse_solver=solver,
                   stop_criteria_thr=0.0)
    jax.clear_caches()
    with jax.log_compiles(True), caplog.at_level(logging.WARNING):
        infere_linear(dm, fx.y, cfg, true_signal=fx.beta, write_outputs=False)
    phase = "_iteration_phase_spectral" if solver == "spectral" else "_iteration_phase"
    compiles = [r.getMessage() for r in caplog.records
                if "Compiling" in r.getMessage()]
    for name in (phase, "_em_phase"):
        n = sum(f"jit({name})" in m for m in compiles)
        assert n == 1, (name, n, compiles)


@pytest.mark.parametrize("solver", ["spectral", "cg"])
def test_mesh_run_compiles_each_phase_once(small_fixture, mesh8, solver,
                                           tmp_path, caplog):
    """On a mesh the loop state starts committed to the design's mesh
    (sharding.commit_like), so iteration 2 — fed the phases' own outputs —
    reuses iteration 1's executables instead of compiling each phase again."""
    import logging

    fx = small_fixture
    dm = build_design(fx.X.T, mesh=mesh8, compute_dtype=jnp.float32)
    cfg = base_cfg(tmp_path, iterations=3, lmmse_solver=solver,
                   stop_criteria_thr=0.0)
    jax.clear_caches()
    with jax.log_compiles(True), caplog.at_level(logging.WARNING):
        infere_linear(dm, fx.y, cfg, true_signal=fx.beta, write_outputs=False)
    phase = "_iteration_phase_spectral" if solver == "spectral" else "_iteration_phase"
    compiles = [r.getMessage() for r in caplog.records
                if "Compiling" in r.getMessage()]
    for name in (phase, "_em_phase"):
        n = sum(f"jit({name})" in m for m in compiles)
        assert n == 1, (name, n, compiles)

"""Probit engine end-to-end tests."""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from vampomi_tpu.config import RunConfig
from vampomi_tpu.engine.probit import infere_bin_class
from vampomi_tpu.io.csv_writer import read_positional_csv
from vampomi_tpu.ops.operator import build_design


@pytest.fixture(scope="module")
def probit_problem():
    from vampomi_tpu.sim.data_sim import simulate_iid

    fx = simulate_iid(n=400, m=300, lam=0.15, h2=0.9, seed=9)
    g = fx.X @ fx.beta
    rng = np.random.default_rng(10)
    ybin = (g + rng.normal(0, np.sqrt(0.1), len(g)) > 0).astype(float)
    return fx, ybin


def probit_cfg(tmp, **kw):
    d = dict(
        out_dir=str(tmp), out_name="pb", model="bin_class", iterations=6,
        rho=0.3, gam1=1e-2, probs=[0.85, 0.1, 0.05], vars=[0.0, 1e-3, 1e-2],
        stop_criteria_thr=1e-8, seed=3,
    )
    d.update(kw)
    return RunConfig(**d)


def test_probit_end_to_end(probit_problem, tmp_path):
    fx, ybin = probit_problem
    dm = build_design(fx.X.T, mesh=None, compute_dtype=jnp.float64)
    cfg = probit_cfg(tmp_path)
    res = infere_bin_class(dm, ybin, cfg, true_signal=fx.beta, write_outputs=True)

    # accuracy and signal recovery beat chance by a wide margin
    final = res.metrics_history[-1]
    assert final[4] > 0.75, f"denoiser accuracy {final[4]}"
    assert final[5] > 0.7, f"x1 corr {final[5]}"
    tp, tn, fp, fn = final[0], final[1], final[2], final[3]
    assert tp + tn + fp + fn == len(ybin)

    # artifacts written, params row has the probit 8-value layout
    assert os.path.exists(tmp_path / "pb_it_1.bin")
    assert os.path.exists(tmp_path / "pb_r1_it_1.bin")
    params = read_positional_csv(os.path.join(tmp_path, "pb_params.csv"))
    assert len(params[0]) == 9  # iteration + 8 values under the 6-name header
    prior_rows = read_positional_csv(os.path.join(tmp_path, "pb_prior.csv"))
    assert prior_rows[0][1] == 3.0  # number of active components


def test_probit_covariates(probit_problem, tmp_path):
    fx, _ = probit_problem
    n = fx.X.shape[0]
    rng = np.random.default_rng(4)
    Z = rng.normal(size=(n, 2))
    eta_true = np.array([1.0, -0.7])
    g = fx.X @ fx.beta
    ybin = (g + Z @ eta_true + rng.normal(0, np.sqrt(0.1), n) > 0).astype(float)

    dm = build_design(fx.X.T, mesh=None, compute_dtype=jnp.float64)
    cfg = probit_cfg(tmp_path, C=2, iterations=4)
    res = infere_bin_class(
        dm, ybin, cfg, true_signal=fx.beta, covariates=Z, write_outputs=False
    )
    assert res.cov_eff is not None
    # covariate effects recovered with the right signs and rough magnitude
    assert res.cov_eff[0] > 0.3 and res.cov_eff[1] < -0.2


def test_probit_shard_invariance(probit_problem, tmp_path, mesh8):
    fx, ybin = probit_problem
    cfg = probit_cfg(tmp_path, iterations=3)
    dm1 = build_design(fx.X.T, mesh=None, compute_dtype=jnp.float64)
    dm8 = build_design(fx.X.T, mesh=mesh8, compute_dtype=jnp.float64)
    r1 = infere_bin_class(dm1, ybin, cfg, true_signal=fx.beta, write_outputs=False)
    r8 = infere_bin_class(dm8, ybin, cfg, true_signal=fx.beta, write_outputs=False)
    np.testing.assert_allclose(r8.x1_hat_scaled, r1.x1_hat_scaled, rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("dtype", [jnp.int8, "int4"])
def test_probit_quantized_design(probit_problem, tmp_path, dtype):
    """The probit engine runs on quantized designs (same operator path as
    linear; the quantizer only perturbs X)."""
    from vampomi_tpu.ops.operator import PACKED4_DTYPE

    fx, ybin = probit_problem
    dm = build_design(
        fx.X.T, mesh=None,
        compute_dtype=PACKED4_DTYPE if dtype == "int4" else dtype,
    )
    cfg = probit_cfg(tmp_path, out_name=f"pbq_{dtype}")
    res = infere_bin_class(dm, ybin, cfg, true_signal=fx.beta,
                           write_outputs=False)
    final = res.metrics_history[-1]
    assert final[4] > 0.7, f"denoiser accuracy {final[4]}"
    assert final[5] > 0.6, f"x1 corr {final[5]}"


@pytest.mark.parametrize("on_mesh", [False, True])
def test_probit_run_compiles_each_phase_once(tmp_path, mesh8, caplog,
                                             on_mesh):
    """The probit loop compiles its phase once per run, on a mesh too, with
    N equal to the padded marker count (the loop state is committed by
    role, sharding.commit_like, not by length)."""
    import logging

    import jax

    from vampomi_tpu.sim.data_sim import simulate_iid

    fx = simulate_iid(n=256, m=256, lam=0.1, h2=0.9, seed=5)
    ybin = (fx.X @ fx.beta > 0).astype(float)
    dm = build_design(fx.X.T, mesh=mesh8 if on_mesh else None,
                      compute_dtype=jnp.float32)
    assert dm.m_pad == int(dm.n)
    cfg = probit_cfg(tmp_path, iterations=3, stop_criteria_thr=0.0,
                     lmmse_solver="spectral")
    jax.clear_caches()
    with jax.log_compiles(True), caplog.at_level(logging.WARNING):
        res = infere_bin_class(dm, ybin, cfg, true_signal=fx.beta,
                               write_outputs=False)
    assert np.all(np.isfinite(res.x1_hat_scaled))
    compiles = [r.getMessage() for r in caplog.records
                if "Compiling" in r.getMessage()]
    for name in ("_probit_phase", "_em_phase"):
        n = sum(f"jit({name})" in m for m in compiles)
        assert n == 1, (name, n, compiles)


def test_probit_eigen_build_budget_falls_back(small_fixture):
    """--eigen-build-budget on the probit engine: an overrunning build
    must fall back to the spectral factor path and still complete."""
    from vampomi_tpu.config import RunConfig
    from vampomi_tpu.engine.probit import infere_bin_class

    fx = small_fixture
    dm = build_design(fx.X.T, mesh=None, compute_dtype=jnp.float32)
    y_bin = (fx.y > np.median(fx.y)).astype(np.float64)
    cfg = RunConfig(
        out_dir="/tmp", out_name="pbud_t", iterations=3, meth_file="x",
        model="bin_class", probs=[0.9, 0.07, 0.03], vars=[0.0, 1e-3, 1e-2],
        h2=0.8, stop_criteria_thr=0.0,
        lmmse_solver="eigen", eigen_build_budget=1e-9,
    )
    res = infere_bin_class(dm, y_bin, cfg, true_signal=fx.beta,
                           write_outputs=False)
    assert res.iterations_run == 3
    assert np.all(np.isfinite(res.x1_hat_scaled))

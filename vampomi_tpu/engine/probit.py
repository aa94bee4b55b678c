"""Probit (binary classification) GLM-VAMP driver.

Reference: `vamp::infere_bin_class` (src/vamp_probit.cpp:19-467) — four
half-steps per iteration over the pair (x, z = A x):

  1. denoise x with the spike+mixture prior (g1/g1d, as in the linear model),
     with rho-damping applied to BOTH x1_hat and alpha1 for it > 1
     (src/vamp_probit.cpp:160-165);
  2. denoise z with the probit-likelihood posterior (g1_bin_class) and form
     the extrinsic pair (p2, tau2) (src/vamp_probit.cpp:213-253);
  3. LMMSE x: CG solve of (tau2 A^T A + gam2 I) x = tau2 A^T p2 + gam2 r2,
     fresh zero start each iteration (src/vamp_probit.cpp:300-311), Onsager
     alpha2 via the Hutchinson probe;
  4. LMMSE z: z2 = A x2, beta2 = (Mt/N)(1 - alpha2), extrinsic (p1, tau1)
     (src/vamp_probit.cpp:352-376).

Faithful quirks: eta1 uses the UNdamped alpha1 (src/vamp_probit.cpp:130)
while r2 uses the damped x1_hat; g1 runs with the PREVIOUS iteration's prior
(updatePrior is called after the denoiser, src/vamp_probit.cpp:113,139); the
prior CSV row stores the internally-scaled (×N) variances
(src/vamp_probit.cpp:427-428); the params CSV has 8 values under the 6-name
linear header (src/vamp.cpp:72-77 + vamp_probit.cpp:22).
"""

from __future__ import annotations

import functools
import time
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding

from ..config import RunConfig
from ..sharding import commit_like, fetch_global
from ..glm.probit import g1_bin_class, g1d_bin_class, newton_method_cov
from ..io.bin_io import iteration_file, write_bin_slab, write_marker_file
from ..io.csv_writer import PositionalCSV
from ..ops.cg import cg_solve
from ..ops.operator import DesignMatrix, atx, ax, jit_for_design
from ..ops.spectral import (
    build_spectral, default_nb, shift_inverse, spectral_solve, spectral_traces,
)
from ..prior.mixture import MixturePrior, em_update, g1, g1d
from .linear import (
    GAMMA_MIN, GAMMA_MAX, METRICS_HEADER, PARAMS_HEADER, _log,
    build_eigen_budgeted, choose_lmmse_solver, warn_em_stability,
)
from .metrics import confusion_counts


def _clamp(x):
    return jnp.minimum(jnp.maximum(x, GAMMA_MIN), GAMMA_MAX)


class ProbitResult(NamedTuple):
    x1_hat_scaled: np.ndarray
    iterations_run: int
    gam1: float
    tau1: float
    cov_eff: np.ndarray | None
    probs: np.ndarray
    vars: np.ndarray
    metrics_history: list
    # final denoiser-input extrinsic in file units (r1/sqrt(N)); see
    # engine/linear.py LinearResult.r1_scaled for the (r1, gam1) pairing
    r1_scaled: np.ndarray | None = None
    # per-iteration wall seconds (utils/telemetry.py Tracer records) — lets
    # callers measure steady-state it/s without diffing two runs whose
    # compile costs may not cancel (tools/probit_northstar.py)
    iter_seconds: list | None = None


@functools.partial(jax.jit, static_argnames=("solver", "debug"))
def _probit_phase(
    dm: DesignMatrix,
    y,                # 0/1 labels (N,)
    m_cov,            # covariate offsets Z @ cov_eff (N,)
    r1, r2, p1, p2,
    gam1, tau1, gam2_in, alpha1_prev,
    prior: MixturePrior,
    x1_hat_prev,
    damp, rho, probit_var,
    bern,
    true_signal_scaled,   # sqrt(N) * beta, padded
    cg_max_iter, cg_err_tol,
    fac=None,             # SpectralFactor when solver == "spectral"
    solver: str = "cg",
    debug: bool = False,  # static: --verbosity 1 per-CG-iteration prints
):
    # Dtype policy: M/N vectors in the work dtype; scalars f64 (see
    # engine/linear.py).
    wd = dm.wd
    c = lambda s: jnp.asarray(s).astype(wd)  # noqa: E731
    r1 = r1.astype(wd)
    r2 = r2.astype(wd)
    p1 = p1.astype(wd)
    p2 = p2.astype(wd)
    y = y.astype(wd)
    m_cov = m_cov.astype(wd)
    x1_hat_prev = x1_hat_prev.astype(wd)
    bern = bern.astype(wd)
    ts = true_signal_scaled.astype(wd)
    inv_sqrt_n = c(1.0 / jnp.sqrt(dm.n))

    # ---------- denoise x (src/vamp_probit.cpp:97-165) ----------
    x1_new = g1(r1, gam1, prior)
    alpha1_new = jnp.sum(g1d(r1, gam1, prior) * dm.mmask).astype(jnp.float64) / dm.mt
    eta1 = gam1 / alpha1_new  # uses UNdamped alpha1 (line 130)

    x1_hat = jnp.where(damp, c(rho) * x1_new + c(1.0 - rho) * x1_hat_prev, x1_new)
    alpha1 = jnp.where(damp, rho * alpha1_new + (1.0 - rho) * alpha1_prev, alpha1_new)

    def corr(a, b):
        den = jnp.sqrt(jnp.dot(a, a) * jnp.dot(b, b))
        return (jnp.dot(a, b) / jnp.where(den == 0.0, 1.0, den)).astype(jnp.float64)

    x1_corr = corr(x1_hat, ts)

    gam2 = _clamp(eta1 - gam1)
    r2_new = (c(eta1) * x1_hat - c(gam1) * r1) / c(gam2)

    # ---------- denoise z (src/vamp_probit.cpp:200-253) ----------
    z1_hat = g1_bin_class(p1, c(tau1), y, m_cov, c(probit_var))
    beta1 = jnp.sum(g1d_bin_class(p1, c(tau1), y, m_cov, c(probit_var))).astype(jnp.float64)
    beta1 = jnp.where(beta1 >= dm.n, dm.n - 1.0, beta1) / dm.n
    p2_new = (z1_hat - c(beta1) * p1) / c(1.0 - beta1)
    tau2 = tau1 * (1.0 - beta1) / beta1

    # ---------- LMMSE x (src/vamp_probit.cpp:291-346) ----------
    v = c(tau2) * atx(dm, p2_new) + c(gam2) * r2_new
    if solver == "eigen":
        # once-per-dataset eigenbasis of K (ops/eigen.py): the per-iteration
        # dense work is two N^2 matvecs even though tau2 moves every
        # iteration — `fac` carries the EigenFactor here
        from ..ops.eigen import eigen_solve, eigen_traces
        from ..ops.operator import ax_batch

        Z = ax_batch(dm, jnp.stack([x1_hat * inv_sqrt_n, v], axis=1))
        z1_pred = Z[:, 0]
        av = Z[:, 1]
        x2_hat, z2_hat = eigen_solve(dm, fac, v, tau2, gam2, av=av)
        tr_qinv, _ = eigen_traces(fac, dm.mt, tau2, gam2)
        alpha2 = gam2 * tr_qinv / dm.mt
        cg_iters = jnp.asarray(0)
    elif solver == "spectral":
        # exact Woodbury solve + closed-form Onsager (ops/spectral.py); tau2
        # varies per iteration but the Gram factor is shift-invariant.
        # z1_pred (denoising metrics, src/vamp_probit.cpp:269-287) shares the
        # A-pass with A v — three X passes per probit iteration total.
        from ..ops.operator import ax_batch

        Z = ax_batch(dm, jnp.stack([x1_hat * inv_sqrt_n, v], axis=1))
        z1_pred = Z[:, 0]
        av = Z[:, 1]
        winv = shift_inverse(fac, tau2, gam2, nb=default_nb(fac.n))
        x2_hat, z2_hat = spectral_solve(dm, fac, v, tau2, gam2, av=av, winv=winv)
        tr_qinv, _ = spectral_traces(fac, dm.mt, tau2, gam2, winv=winv)
        alpha2 = gam2 * tr_qinv / dm.mt
        cg_iters = jnp.asarray(0)
    else:
        z1_pred = ax(dm, x1_hat * inv_sqrt_n)
        V = jnp.stack([v, bern], axis=1)
        MU0 = jnp.zeros_like(V)  # probit CG starts from zero every iteration
        res = cg_solve(
            dm, V, MU0, tau2, gam2,
            max_iter=cg_max_iter, tol=cg_err_tol,
            onsager_cols=jnp.asarray([False, True]),
            debug=debug,
        )
        x2_hat = res.mu[:, 0]
        invq_bern = res.mu[:, 1]
        alpha2 = gam2 * jnp.dot(bern, invq_bern).astype(jnp.float64)
        z2_hat = ax(dm, x2_hat)
        cg_iters = res.iters

    # metrics, denoising half (src/vamp_probit.cpp:269-287)
    y1_hat = (jax.scipy.stats.norm.cdf(z1_pred) >= 0.5).astype(wd)
    tp1, tn1, fp1, fn1 = confusion_counts(y, y1_hat)
    acc1 = ((tp1 + tn1) / dm.n).astype(jnp.float64)

    x2_corr = corr(x2_hat, ts)

    r1_new = (x2_hat - c(alpha2) * r2_new) / c(1.0 - alpha2)
    gam1_new = _clamp(gam2 * (1.0 - alpha2) / alpha2)

    # ---------- LMMSE z (src/vamp_probit.cpp:351-376) ----------
    beta2 = dm.mt / dm.n * (1.0 - alpha2)
    p1_new = (z2_hat - c(beta2) * p2_new) / c(1.0 - beta2)
    tau1_new = _clamp(tau2 * (1.0 - beta2) / beta2)

    # metrics, LMMSE half (src/vamp_probit.cpp:402-420); the reference
    # recomputes Ax at x2/sqrt(N) — algebraically z2_hat * inv_sqrt_n
    z2_pred = z2_hat * inv_sqrt_n
    y2_hat = (jax.scipy.stats.norm.cdf(z2_pred) >= 0.5).astype(wd)
    tp2, tn2, fp2, fn2 = confusion_counts(y, y2_hat)
    acc2 = ((tp2 + tn2) / dm.n).astype(jnp.float64)

    metrics = jnp.stack(
        [
            tp1.astype(jnp.float64), tn1.astype(jnp.float64),
            fp1.astype(jnp.float64), fn1.astype(jnp.float64), acc1, x1_corr,
            tp2.astype(jnp.float64), tn2.astype(jnp.float64),
            fp2.astype(jnp.float64), fn2.astype(jnp.float64), acc2, x2_corr,
        ]
    )
    params = jnp.stack([alpha1, beta1, gam1, tau1, alpha2, beta2, gam2, tau2])

    # stopping-criterion NMSE on-device (src/vamp_probit.cpp:440-462)
    dx = x1_hat - x1_hat_prev
    denom = jnp.dot(x1_hat_prev, x1_hat_prev).astype(jnp.float64)
    nmse = jnp.where(
        denom > 0.0,
        jnp.sqrt(jnp.dot(dx, dx).astype(jnp.float64) / jnp.where(denom > 0.0, denom, 1.0)),
        jnp.inf,
    )

    return dict(
        nmse=nmse,
        x1_hat=x1_hat, alpha1=alpha1, gam2=gam2, r2=r2_new,
        x2_hat=x2_hat, alpha2=alpha2, r1=r1_new, gam1=gam1_new,
        # N-length duals leave in the WORK dtype (house policy — and the
        # next iteration feeds them straight back in: an f64 leak here
        # changed the phase's input avals at iteration 2, forcing a full
        # silent recompile every run)
        p1=p1_new.astype(wd), p2=p2_new.astype(wd),
        tau1=tau1_new, tau2=tau2,
        z1_hat=z1_hat, metrics=metrics, params=params, cg_iters=cg_iters,
    )


def infere_bin_class(
    dm: DesignMatrix,
    y: np.ndarray,
    cfg: RunConfig,
    true_signal: np.ndarray | None = None,
    x1hat_init: np.ndarray | None = None,
    covariates: np.ndarray | None = None,
    write_outputs: bool = True,
) -> ProbitResult:
    from ..prior.mixture import init_prior

    M_pad = dm.m_pad
    Mt = int(dm.mt)
    N = int(dm.n)
    sqrt_n = float(np.sqrt(N))
    wd = dm.wd
    verbose = True

    def pad_m(vec):
        out = np.zeros(M_pad, dtype=np.float64)
        if vec is not None:
            out[: len(vec)] = vec
        return jnp.asarray(out, dtype=wd)

    ts_scaled = pad_m(np.asarray(true_signal) * sqrt_n if true_signal is not None else None)
    init_vec = pad_m(np.asarray(x1hat_init) / sqrt_n if x1hat_init is not None else None)
    x1_hat = init_vec
    r1 = jnp.zeros(M_pad, dtype=wd)   # src/vamp_probit.cpp:55
    r2 = jnp.zeros(M_pad, dtype=wd)
    # strong f64 scalars — same iteration-2 recompile trap as the
    # linear engine (engine/linear.py)
    alpha1 = jnp.asarray(0.0, dtype=jnp.float64)

    y_j = jnp.asarray(np.asarray(y, dtype=np.float64), dtype=wd)
    prior = init_prior(cfg.probs, cfg.vars, N)
    gam1 = jnp.asarray(float(cfg.gam1), dtype=jnp.float64)
    tau1 = gam1  # src/vamp_probit.cpp:35
    gam2 = jnp.asarray(0.0, dtype=jnp.float64)
    rho = jnp.asarray(float(cfg.rho), dtype=jnp.float64)
    probit_var = jnp.asarray(float(cfg.probit_var), dtype=jnp.float64)

    key = jax.random.PRNGKey(cfg.seed)
    key, sub = jax.random.split(key)
    p1 = jax.random.normal(sub, (N,), dtype=wd)  # src/vamp_probit.cpp:53
    p2 = jnp.zeros(N, dtype=wd)

    cov_eff = None
    m_cov = jnp.zeros(N, dtype=wd)
    if cfg.C > 0 and covariates is not None and covariates.shape[1] > 0:
        cov_eff = newton_method_cov(
            np.asarray(y), np.zeros(N), covariates, np.zeros(cfg.C),
            probit_var=cfg.probit_var, verbosity=cfg.verbosity,
        )
        m_cov = jnp.asarray(covariates @ cov_eff, dtype=wd)

    it_start = 1
    if cfg.resume_file:
        from .checkpoint import check_meta, load_checkpoint, restore_key

        ck = load_checkpoint(cfg.resume_file)
        check_meta(ck, model="bin_class", mt=Mt, n=N, m_pad=M_pad)
        a = ck["arrays"]
        x1_hat = jnp.asarray(a["x1_hat"], dtype=wd)
        r1 = jnp.asarray(a["r1"], dtype=wd)
        r2 = jnp.asarray(a["r2"], dtype=wd)
        p1 = jnp.asarray(a["p1"], dtype=wd)
        p2 = jnp.asarray(a["p2"], dtype=wd)
        if "m_cov" in a:
            m_cov = jnp.asarray(a["m_cov"], dtype=wd)
        s = ck["scalars"]
        gam1 = jnp.asarray(s["gam1"], dtype=jnp.float64)
        tau1 = jnp.asarray(s["tau1"], dtype=jnp.float64)
        gam2 = jnp.asarray(s["gam2"], dtype=jnp.float64)
        alpha1 = jnp.asarray(s["alpha1"], dtype=jnp.float64)
        prior = MixturePrior(
            probs=jnp.asarray(ck["prior"]["probs"]),
            vars=jnp.asarray(ck["prior"]["vars"]),
            active=jnp.asarray(ck["prior"]["active"]),
        )
        key = restore_key(ck["rng_key"])
        it_start = ck["iteration"] + 1
        _log(True, f"...resumed exact state from {cfg.resume_file} at iteration {it_start}")

    (x1_hat, r1, r2), (p1, p2, gam1, tau1, gam2, alpha1, prior) = commit_like(
        dm.X, (x1_hat, r1, r2), (p1, p2, gam1, tau1, gam2, alpha1, prior))

    out_params = out_metrics = out_prior = None
    if write_outputs:
        prior_header = (
            ["iteration", "number of components"]
            + [f"prob{i}" for i in range(len(cfg.probs))]
            + [f"var{i}" for i in range(len(cfg.vars))]
        )
        import os as _os

        base = f"{cfg.out_dir}/{cfg.out_name}"

        def _csv(path, header):
            # resuming must APPEND to pre-crash positional rows, not recreate
            fresh = (not cfg.resume_file) or not _os.path.exists(path)
            return PositionalCSV(path, header, create=fresh)

        out_metrics = _csv(base + "_metrics.csv", METRICS_HEADER)
        out_params = _csv(base + "_params.csv", PARAMS_HEADER)
        out_prior = _csv(base + "_prior.csv", prior_header)

    n_devices = 1
    if isinstance(dm.X.sharding, NamedSharding):
        n_devices = int(np.prod(dm.X.sharding.mesh.devices.shape))
    solver = choose_lmmse_solver(cfg, Mt, N, n_devices)
    warn_em_stability(cfg, Mt, N)
    fac = None
    if solver in ("spectral", "eigen"):
        t_fac = time.time()
        fac = build_spectral(dm)
        jax.block_until_ready(fac.K)
        _log(verbose, f"spectral LMMSE factor built in {time.time() - t_fac:.3f}s "
                      f"(N={N}; exact solves + exact Onsager from here on)")
    if solver == "eigen":
        t_eig = time.time()
        ef, eig_diag = build_eigen_budgeted(fac, cfg, verbose)
        if ef is None:
            solver = "spectral"
        else:
            _log(verbose, f"eigenbasis of K "
                          f"{'loaded' if eig_diag.get('loaded') else 'built'} "
                          f"in {time.time() - t_eig:.3f}s "
                          f"(residual {eig_diag['resid']:.2e})")
            if eig_diag["resid"] > 1e-3:
                _log(verbose, "eigen residual above tolerance — falling back "
                              "to the per-iteration factor path")
                solver = "spectral"
            else:
                fac = ef  # _probit_phase's `fac` slot carries the EigenFactor

    from ..utils.telemetry import Tracer

    tracer = Tracer(
        path=(f"{cfg.out_dir}/{cfg.out_name}_trace.jsonl"
              if write_outputs and cfg.trace else None),
        model="bin_class",
        solver=solver,
    )
    # bytes per MATRIX ELEMENT an HBM pass moves: 0.5 for the packed
    # int4 layout (two codes per byte), else the storage itemsize
    itemsize = (0.5 if dm.X.dtype == jnp.uint8
                else jnp.dtype(dm.X.dtype).itemsize)

    from ..utils.async_writer import AsyncWriter

    writer = AsyncWriter()

    def _materialize(a):
        """Cross-process gathers are collectives and must run on the MAIN
        thread (every process in lockstep) — never on the IO thread.  Fully
        addressable arrays pass through; the worker fetches those lazily."""
        return a if getattr(a, "is_fully_addressable", True) else fetch_global(a)

    def _dump_iteration(k, x1_dev, r1_dev):
        # per-host slab writes of the shared artifact file (io/bin_io.py)
        write_marker_file(
            iteration_file(cfg.out_dir, cfg.out_name, k), x1_dev, Mt, sqrt_n
        )
        write_marker_file(
            iteration_file(cfg.out_dir, cfg.out_name, k, kind="r1_"),
            r1_dev, Mt, sqrt_n,
        )

    def _save_ckpt(k, arrays_dev, scalars, prior_k, key_k):
        from .checkpoint import save_checkpoint

        save_checkpoint(
            cfg.checkpoint_file,
            iteration=k,
            arrays={
                name: fetch_global(a).astype(np.float64)
                for name, a in arrays_dev.items()
            },
            scalars=scalars,
            prior=prior_k,
            key=key_k,
            meta=dict(model="bin_class", mt=Mt, n=N, m_pad=M_pad),
        )

    metrics_history = []
    it_done = 0

    try:
        for it in range(it_start, cfg.iterations + 1):
            t0 = time.time()
            tracer.start()
            _log(verbose, f"\n********************\niteration = {it}\n********************")

            key, sub = jax.random.split(key)
            if solver in ("spectral", "eigen"):
                bern = jnp.zeros(M_pad, dtype=wd)  # probe unused: traces are exact
            else:
                bern = (
                    jax.random.rademacher(sub, (M_pad,), dtype=wd)
                    * jnp.asarray(1.0 / np.sqrt(float(Mt)), dtype=wd)
                ) * dm.mmask

            x1_prev = x1_hat
            r1_in = r1
            out = jit_for_design(_probit_phase, dm, ("solver", "debug"))(
                dm, y_j, m_cov, r1, r2, p1, p2,
                gam1, tau1, gam2, alpha1, prior, x1_prev,
                jnp.asarray(it > 1), rho, probit_var, bern, ts_scaled,
                jnp.asarray(cfg.CG_max_iter), jnp.asarray(cfg.CG_err_tol),
                fac=fac, solver=solver, debug=cfg.verbosity == 1,
            )

            # EM prior update for the NEXT iteration (g1 above used the old prior;
            # reference calls updatePrior after the denoiser, src/vamp_probit.cpp:139)
            if it > 1:
                from .linear import _em_phase

                prior = _em_phase(
                    dm, r1_in, gam1, prior,
                    jnp.asarray(cfg.EM_max_iter), jnp.asarray(cfg.EM_err_thr),
                    jnp.asarray(bool(cfg.learn_vars)), jnp.asarray(cfg.merge_vars_thr),
                    jnp.asarray(cfg.em_signal_budget(N), dtype=jnp.float64),
                    debug=cfg.verbosity == 1,
                )

            x1_hat = out["x1_hat"]
            alpha1 = out["alpha1"]
            r1, r2 = out["r1"], out["r2"]
            p1, p2 = out["p1"], out["p2"]
            gam1, gam2, tau1 = out["gam1"], out["gam2"], out["tau1"]

            # one batched fetch of every O(1) output
            host, prior_h = jax.device_get(
                ({k: out[k] for k in (
                    "params", "metrics", "cg_iters", "nmse",
                    "gam1", "tau1", "gam2", "alpha1",
                )}, prior)
            )

            # artifact dumps on the IO thread, overlapping the next iteration
            if write_outputs:
                writer.submit(_dump_iteration, it, x1_hat, r1_in)

            metrics = np.asarray(host["metrics"])
            metrics_history.append(metrics)
            if write_outputs:
                out_params.write_row(it, np.asarray(host["params"]).tolist())
                out_metrics.write_row(it, metrics.tolist())
                act = np.asarray(prior_h.active)
                pr = np.asarray(prior_h.probs)[act]
                vr = np.asarray(prior_h.vars)[act]  # internal ×N scale (line 428)
                out_prior.write_row(it, [float(len(pr))] + pr.tolist() + vr.tolist())

            _log(verbose, f"params [a1,b1,g1,t1,a2,b2,g2,t2] = {np.asarray(host['params'])}")
            _log(verbose, f"acc1 = {metrics[4]:.4f}, acc2 = {metrics[10]:.4f}, "
                          f"x1_corr = {metrics[5]:.4f}, CG iters = {int(host['cg_iters'])}")

            rec = tracer.stop(
                it, int(host["cg_iters"]), M_pad, N, itemsize,
                gam1=float(host["gam1"]), tau1=float(host["tau1"]),
            )
            _log(verbose, f"iteration time = {rec.seconds:.3f}s  "
                          f"(~{rec.matrix_passes} matrix passes, {rec.gbps:.1f} GB/s)  "
                          f"total = {tracer.total_comp_time:.3f}s")

            if cfg.checkpoint_file:
                writer.submit(
                    _save_ckpt, it,
                    {k: _materialize(a) for k, a in dict(
                        x1_hat=x1_hat, r1=r1, r2=r2, p1=p1, p2=p2, m_cov=m_cov,
                    ).items()},
                    dict(
                        gam1=float(host["gam1"]), tau1=float(host["tau1"]),
                        gam2=float(host["gam2"]), alpha1=float(host["alpha1"]),
                    ),
                    prior, key,
                )

            it_done = it

            nmse = float(host["nmse"])
            _log(verbose, f"x1_hat NMSE = {nmse if np.isfinite(nmse) else 'n/a (zero previous iterate)'}")
            if it > 1 and nmse < cfg.stop_criteria_thr:
                _log(verbose, "...stopping criteria fulfilled")
                break

    finally:
        writer.close()  # artifacts durably on disk even on error paths
    x1_scaled = fetch_global(x1_hat).astype(np.float64)[:Mt] / sqrt_n

    act = np.asarray(prior.active)
    return ProbitResult(
        x1_hat_scaled=x1_scaled,
        iterations_run=it_done,
        gam1=float(gam1),
        tau1=float(tau1),
        cov_eff=cov_eff,
        probs=np.asarray(prior.probs)[act],
        vars=np.asarray(prior.vars)[act],
        metrics_history=metrics_history,
        r1_scaled=fetch_global(r1).astype(np.float64)[:Mt] / sqrt_n,
        iter_seconds=[r.seconds for r in tracer.records],
    )

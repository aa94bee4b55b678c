"""Linear-model gVAMP driver (reference: `vamp::infere_linear`,
src/vamp.cpp:110-438).

Structure: a host-driven outer loop (it writes per-iteration artifacts and
applies the host-side component merge) around two large jitted phases:

  * `_em_phase`      — the EM prior update (reference src/vamp.cpp:531-643)
  * `_iteration_phase` — denoising + LMMSE + noise-precision update +
    error measures, fused into one XLA program.  The LMMSE solve and the
    Onsager trace-probe solve run as a single multi-RHS CG (see ops/cg.py),
    sharing every HBM pass over the design matrix.

All scalar hyperparameters are traced (passed as f64 arrays), so the phases
compile exactly once per run.

Scaling conventions (must match the reference to reproduce its numbers):
  * internal x-vectors carry a sqrt(N) factor (A has 1/sqrt(N) baked in);
  * saved estimates are divided by sqrt(N) (src/vamp.cpp:237-239);
  * prior variances were multiplied by N at init (src/vamp.cpp:87-88);
  * gamma clamps [1e-11, 1e11] (src/vamp.hpp:33-34);
  * gam1 is damped with rho after the LMMSE step (src/vamp.cpp:346), x1_hat
    is damped after denoising for it > 1 (src/vamp.cpp:208-211).
"""

from __future__ import annotations

import functools
import sys
import time
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding

from ..config import RunConfig
from ..sharding import commit_like, fetch_global
from ..io.bin_io import iteration_file, write_bin_slab, write_marker_file
from ..io.csv_writer import PositionalCSV
from ..ops.cg import cg_solve
from ..ops.eigen import EigenFactor, build_eigen, eigen_weights
from ..ops.operator import DesignMatrix, atx, ax, ax_batch, jit_for_design
from ..ops.spectral import (
    GramFactor, build_spectral, default_nb, shift_inverse, spectral_solve,
    spectral_traces,
)
from ..prior.mixture import (
    MixturePrior, em_update, g1, g1d, merge_components_device,
)
from .metrics import prediction_metrics, signal_metrics

GAMMA_MIN = 1e-11  # reference src/vamp.hpp:33
GAMMA_MAX = 1e11   # reference src/vamp.hpp:34

METRICS_HEADER = [
    "iteration",
    "R2 denoising",
    "x1 correlation denoising",
    "R2 LMMSE",
    "x2 correlation LMMSE",
    "z1 correlation denoising",
    "z2 correlation LMMSE",
]
PARAMS_HEADER = ["iteration", "alpha1", "gam1", "alpha2", "gam2", "gamw"]


def _clamp(x):
    return jnp.minimum(jnp.maximum(x, GAMMA_MIN), GAMMA_MAX)


class LinearResult(NamedTuple):
    x1_hat_scaled: np.ndarray   # (Mt,) estimate in file units (x1_hat/sqrt(N))
    iterations_run: int
    gam1: float
    gamw: float
    probs: np.ndarray
    vars: np.ndarray            # internal (×N) scale
    metrics_history: list
    # final LMMSE extrinsic in file units (r1/sqrt(N)) — the (r1, gam1) pair
    # the NEXT denoising step would consume, i.e. what `_r1_it_<k+1>.bin`
    # plus the params-CSV gam1 column give the offline SE p-value script
    # (reference scripts/p_vals.py:44-62).  Lets api.association_pvals work
    # fully in memory, no iteration dumps needed.
    r1_scaled: np.ndarray | None = None
    # per-iteration wall seconds (utils/telemetry.py Tracer records) — lets
    # callers measure steady-state it/s without diffing two runs whose
    # compile costs may not cancel (tools/probit_northstar.py)
    iter_seconds: list | None = None
    # once-per-dataset set-up: {"gram_s", "eigen_s", "eigen_resid"} for the
    # pieces the run's solver built (wall seconds, compiles included)
    setup: dict | None = None


@functools.partial(jax.jit, static_argnames=("debug",))
def _em_phase(dm: DesignMatrix, r1, gam1, prior: MixturePrior,
              em_max_iter, em_err_thr, learn_vars, merge_vars_thr,
              signal_budget, debug: bool = False):
    """EM prior update + component merge, one jitted dispatch
    (reference: src/vamp.cpp:531-643 updatePrior + 627-642 merge).
    `debug` (static) compiles in the --verbosity 1 per-EM-iteration prints.

    `signal_budget` (traced f64 scalar, 0 = off = reference parity) is the
    truth-free EM stabilizer for wide M/N: under the model the slab's total
    second moment  mt·λ·v̄ = mt·Σ_{j≥1} p_j v_j  (internal scale, vars ×N)
    cannot exceed N·h2_max, because the standardized phenotype has unit
    variance (src/data.cpp:88-103) so h2 ≤ 1.  At M/N ≥ 16 the EM inherited
    from src/vamp.cpp:531-643 attributes the γ1-miscalibration excess in r1
    to the slab — λ and v̄ run away together (measured 200× over budget at
    the EM_STABILITY collapse point) and the trajectory collapses.
    Rescaling the slab variances back onto the budget after each EM call
    pins the total while EM keeps allocating sparsity-vs-magnitude freely;
    measured on the oracle at M/N=32 it turns the collapse (corr 0.17,
    λ→0.75) into convergence ABOVE the fixed-prior run (0.48 vs 0.38) and
    is a no-op in regimes where EM is already stable (tools/em_stability.py
    "budget" mode)."""
    prior = em_update(
        r1, gam1, prior, dm.mmask, dm.mt,
        em_max_iter=em_max_iter, em_err_thr=em_err_thr, learn_vars=learn_vars,
        debug=debug,
    )
    prior = merge_components_device(prior, merge_vars_thr)
    slab = jnp.logical_and(prior.active, jnp.arange(prior.L) >= 1)
    total = dm.mt * jnp.sum(jnp.where(slab, prior.probs * prior.vars, 0.0))
    budget = jnp.asarray(signal_budget, dtype=jnp.float64)
    over = jnp.logical_and(budget > 0.0, total > budget)
    scale = jnp.where(over, budget / jnp.where(total > 0.0, total, 1.0), 1.0)
    return MixturePrior(
        probs=prior.probs,
        vars=jnp.where(slab, prior.vars * scale, prior.vars),
        active=prior.active,
    )


@functools.partial(jax.jit, static_argnames=("debug",))
def _iteration_phase(
    dm: DesignMatrix,
    aty_adj,          # A^T y_adj, cached across iterations (src/vamp.cpp:303)
    y_raw,            # original phenotype (gamw + metrics; src/vamp.cpp:506,817)
    r1,
    gam1,
    prior: MixturePrior,
    x1_hat_prev,
    damp,             # bool: apply rho-damping (it > 1)
    rho,
    gamw,
    mu_warm,
    bern,             # Rademacher probe, +-1/sqrt(Mt), zero at padding
    true_signal,      # file units (beta); zeros if unknown
    cg_max_iter,
    cg_err_tol,
    debug: bool = False,   # static: --verbosity 1 per-CG-iteration prints
):
    # Dtype policy: every M/N-length vector lives in the work dtype (f32 on
    # an accelerator — the vectors ride the passes over X, so their bytes
    # count); gammas/alphas and all O(1) bookkeeping stay f64.
    wd = dm.wd
    c = lambda s: jnp.asarray(s).astype(wd)  # noqa: E731 — scalar → work dtype
    r1 = r1.astype(wd)
    x1_hat_prev = x1_hat_prev.astype(wd)
    aty_adj = aty_adj.astype(wd)
    y_raw = y_raw.astype(wd)
    mu_warm = mu_warm.astype(wd)
    bern = bern.astype(wd)
    ts = true_signal.astype(wd)
    sqrt_n_c = c(jnp.sqrt(dm.n))

    # ---------------- denoising (src/vamp.cpp:176-272) ----------------
    x1_new = g1(r1, gam1, prior)
    x1_hat = jnp.where(damp, c(rho) * x1_new + c(1.0 - rho) * x1_hat_prev, x1_new)

    alpha1 = (jnp.sum(g1d(r1, gam1, prior) * dm.mmask)).astype(jnp.float64) / dm.mt
    eta1 = gam1 / alpha1
    z1 = ax(dm, x1_hat)

    gam2 = _clamp(eta1 - gam1)
    r2 = (c(eta1) * x1_hat - c(gam1) * r1) / c(gam2)

    # diagnostic "true" gam2 against the known signal (src/vamp.cpp:263-270)
    dev2 = r2 - sqrt_n_c * ts
    gam2_true = dm.mt / jnp.dot(dev2, dev2).astype(jnp.float64)

    # metrics, denoising half (src/vamp.cpp:760-852, ind=1)
    x1_corr, _ = signal_metrics(x1_hat, ts, dm.n)
    r2_den, corr_y2_den = prediction_metrics(z1, y_raw)

    # ---------------- LMMSE (src/vamp.cpp:287-362) ----------------
    v = c(gamw) * aty_adj + c(gam2) * r2
    V = jnp.stack([v, bern], axis=1)
    MU0 = jnp.stack([mu_warm, jnp.zeros_like(mu_warm)], axis=1)
    res = cg_solve(
        dm, V, MU0, gamw, gam2,
        max_iter=cg_max_iter, tol=cg_err_tol,
        onsager_cols=jnp.asarray([False, True]),
        debug=debug,
    )
    x2_hat = res.mu[:, 0]
    invq_bern = res.mu[:, 1]

    # Hutchinson Onsager (src/vamp.cpp:494-501)
    alpha2 = gam2 * jnp.dot(bern, invq_bern).astype(jnp.float64)
    eta2 = gam2 / alpha2
    gam1_new = _clamp(eta2 - gam2)
    gam1_new = rho * gam1_new + (1.0 - rho) * gam1    # damping (src/vamp.cpp:346)
    r1_new = (c(eta2) * x2_hat - c(gam2) * r2) / c(gam1_new)

    dev1 = r1_new - sqrt_n_c * ts
    gam1_true = dm.mt / jnp.dot(dev1, dev1).astype(jnp.float64)

    # noise precision EM update (src/vamp.cpp:504-529)
    z2 = ax(dm, x2_hat)
    resid = z2 - y_raw
    trace_vec = atx(dm, ax(dm, invq_bern))
    trace_corr = jnp.dot(bern, trace_vec).astype(jnp.float64) * dm.mt
    gamw_new = dm.n / (jnp.dot(resid, resid).astype(jnp.float64) + trace_corr)

    # metrics, LMMSE half (ind=2)
    x2_corr, _ = signal_metrics(x2_hat, ts, dm.n)
    r2_lmmse, corr_y2_lmmse = prediction_metrics(z2, y_raw)

    metrics = jnp.stack(
        [r2_den, x1_corr, r2_lmmse, x2_corr, corr_y2_den, corr_y2_lmmse]
    )

    # stopping-criterion NMSE (src/vamp.cpp:409-423), on-device so the host
    # never fetches M-length vectors just to decide termination
    dx = x1_hat - x1_hat_prev
    denom = jnp.dot(x1_hat_prev, x1_hat_prev).astype(jnp.float64)
    nmse = jnp.where(
        denom > 0.0,
        jnp.sqrt(jnp.dot(dx, dx).astype(jnp.float64) / jnp.where(denom > 0.0, denom, 1.0)),
        jnp.inf,
    )

    return dict(
        nmse=nmse,
        x1_hat=x1_hat,
        alpha1=alpha1,
        eta1=eta1,
        z1=z1,
        gam2=gam2,
        r2=r2,
        x2_hat=x2_hat,
        alpha2=alpha2,
        eta2=eta2,
        gam1=gam1_new,
        r1=r1_new,
        gamw=gamw_new,
        cg_iters=res.iters,
        cg_rel_err=res.rel_err,
        metrics=metrics,
        gam1_true=gam1_true,
        gam2_true=gam2_true,
    )


@jax.jit
def _iteration_phase_spectral(
    dm: DesignMatrix,
    fac: GramFactor,
    aty_adj,          # A^T y_adj, cached across iterations (y_adj is constant)
    y_raw,
    r1,
    gam1,
    prior: MixturePrior,
    x1_hat_prev,
    damp,
    rho,
    gamw,
    true_signal,
):
    """One linear-VAMP iteration with the exact spectral LMMSE solver.

    Identical algorithm to `_iteration_phase` except the LMMSE step: the CG
    solve is replaced by the Woodbury solve (ops/spectral.py) and the
    Hutchinson probe estimates of alpha2 (src/vamp.cpp:494-501) and the
    gamma_w trace correction (src/vamp.cpp:518-521) by their closed forms.
    Exactly two HBM passes over X per iteration (the shared ax_batch and
    atx(q)) — independent of CG_max_iter.
    """
    wd = dm.wd
    c = lambda s: jnp.asarray(s).astype(wd)  # noqa: E731
    r1 = r1.astype(wd)
    x1_hat_prev = x1_hat_prev.astype(wd)
    y_raw = y_raw.astype(wd)
    aty_adj = aty_adj.astype(wd)
    ts = true_signal.astype(wd)
    sqrt_n_c = c(jnp.sqrt(dm.n))

    # ---------------- denoising (src/vamp.cpp:176-272) ----------------
    x1_new = g1(r1, gam1, prior)
    x1_hat = jnp.where(damp, c(rho) * x1_new + c(1.0 - rho) * x1_hat_prev, x1_new)

    alpha1 = (jnp.sum(g1d(r1, gam1, prior) * dm.mmask)).astype(jnp.float64) / dm.mt
    eta1 = gam1 / alpha1

    gam2 = _clamp(eta1 - gam1)
    r2 = (c(eta1) * x1_hat - c(gam1) * r1) / c(gam2)

    dev2 = r2 - sqrt_n_c * ts
    gam2_true = dm.mt / jnp.dot(dev2, dev2).astype(jnp.float64)

    # ---------------- LMMSE, exact (src/vamp.cpp:287-362) ----------------
    # z1 = A x1_hat and A v share ONE pass over X (multi-RHS ax_batch), so a
    # full spectral iteration reads X exactly twice: here and in atx(q).
    v = c(gamw) * aty_adj + c(gam2) * r2
    Z = ax_batch(dm, jnp.stack([x1_hat, v], axis=1))
    z1 = Z[:, 0]
    av = Z[:, 1]
    # fused factor + explicit inverse + trace: one matmul-shaped dense pass
    # per iteration (ops/spectral.py shift_inverse)
    winv = shift_inverse(fac, gamw, gam2, nb=default_nb(fac.n))
    x2_hat, z2 = spectral_solve(dm, fac, v, gamw, gam2, av=av, winv=winv)

    x1_corr, _ = signal_metrics(x1_hat, ts, dm.n)
    r2_den, corr_y2_den = prediction_metrics(z1, y_raw)

    tr_qinv, tr_ata_qinv = spectral_traces(fac, dm.mt, gamw, gam2, winv=winv)
    alpha2 = gam2 * tr_qinv / dm.mt          # exact E[u^T Q^{-1} u], u ~ ±1/sqrt(Mt)
    eta2 = gam2 / alpha2
    gam1_new = _clamp(eta2 - gam2)
    gam1_new = rho * gam1_new + (1.0 - rho) * gam1
    r1_new = (c(eta2) * x2_hat - c(gam2) * r2) / c(gam1_new)

    dev1 = r1_new - sqrt_n_c * ts
    gam1_true = dm.mt / jnp.dot(dev1, dev1).astype(jnp.float64)

    # noise precision EM (src/vamp.cpp:504-529) with the exact trace
    resid = z2 - y_raw
    gamw_new = dm.n / (jnp.dot(resid, resid).astype(jnp.float64) + tr_ata_qinv)

    x2_corr, _ = signal_metrics(x2_hat, ts, dm.n)
    r2_lmmse, corr_y2_lmmse = prediction_metrics(z2, y_raw)

    metrics = jnp.stack(
        [r2_den, x1_corr, r2_lmmse, x2_corr, corr_y2_den, corr_y2_lmmse]
    )

    # stopping-criterion NMSE (src/vamp.cpp:409-423), on-device so the host
    # never fetches M-length vectors just to decide termination
    dx = x1_hat - x1_hat_prev
    denom = jnp.dot(x1_hat_prev, x1_hat_prev).astype(jnp.float64)
    nmse = jnp.where(
        denom > 0.0,
        jnp.sqrt(jnp.dot(dx, dx).astype(jnp.float64) / jnp.where(denom > 0.0, denom, 1.0)),
        jnp.inf,
    )

    return dict(
        nmse=nmse,
        x1_hat=x1_hat,
        alpha1=alpha1,
        eta1=eta1,
        z1=z1,
        gam2=gam2,
        r2=r2,
        x2_hat=x2_hat,
        alpha2=alpha2,
        eta2=eta2,
        gam1=gam1_new,
        r1=r1_new,
        gamw=gamw_new,
        cg_iters=jnp.asarray(0),
        cg_rel_err=jnp.zeros((2,), dtype=jnp.float64),
        metrics=metrics,
        gam1_true=gam1_true,
        gam2_true=gam2_true,
    )


@jax.jit
def _iteration_phase_eigen(
    dm: DesignMatrix,
    ef: EigenFactor,
    aty_adj,
    y_raw,
    r1,
    gam1,
    prior: MixturePrior,
    x1_hat_prev,
    damp,
    rho,
    gamw,
    true_signal,
):
    """One linear-VAMP iteration with the eigen-LMMSE solver.

    Identical algorithm to `_iteration_phase_spectral` except the dense
    step: the per-iteration fused factor (ops/spectral.py shift_inverse,
    ~2N^3/3 FLOPs) is replaced by two N^2 matvecs in the once-per-
    dataset eigenbasis of K (ops/eigen.py), and both traces become exact
    f64 closed forms of the eigenvalues.  Replaces the same reference
    machinery (src/vamp.cpp:494-529, 645-757) at strictly lower
    per-iteration cost — the design that removes the replicated-dense
    Amdahl term from multi-chip scaling (SCALING.md).
    """
    wd = dm.wd
    c = lambda s: jnp.asarray(s).astype(wd)  # noqa: E731
    r1 = r1.astype(wd)
    x1_hat_prev = x1_hat_prev.astype(wd)
    y_raw = y_raw.astype(wd)
    aty_adj = aty_adj.astype(wd)
    ts = true_signal.astype(wd)
    sqrt_n_c = c(jnp.sqrt(dm.n))

    # ---------------- denoising (src/vamp.cpp:176-272) ----------------
    x1_new = g1(r1, gam1, prior)
    x1_hat = jnp.where(damp, c(rho) * x1_new + c(1.0 - rho) * x1_hat_prev, x1_new)

    alpha1 = (jnp.sum(g1d(r1, gam1, prior) * dm.mmask)).astype(jnp.float64) / dm.mt
    eta1 = gam1 / alpha1

    gam2 = _clamp(eta1 - gam1)
    r2 = (c(eta1) * x1_hat - c(gam1) * r1) / c(gam2)

    dev2 = r2 - sqrt_n_c * ts
    gam2_true = dm.mt / jnp.dot(dev2, dev2).astype(jnp.float64)

    # ---------------- LMMSE, exact, in the eigenbasis ----------------
    v = c(gamw) * aty_adj + c(gam2) * r2
    Z = ax_batch(dm, jnp.stack([x1_hat, v], axis=1))
    z1 = Z[:, 0]
    av = Z[:, 1]
    d, T = eigen_weights(ef, gamw, gam2)      # d_i = 1/(gam2 + gamw lam_i)
    with jax.default_matmul_precision("highest"):
        q = ef.U @ (d.astype(wd) * (ef.U.T @ av))   # S^{-1} A v == A x2_hat
    x2_hat = (v - c(gamw) * atx(dm, q)) / c(gam2)
    z2 = q

    x1_corr, _ = signal_metrics(x1_hat, ts, dm.n)
    r2_den, corr_y2_den = prediction_metrics(z1, y_raw)

    # exact traces from the eigenvalues (ops/spectral.py counting argument)
    n64 = jnp.asarray(float(ef.n), dtype=jnp.float64)
    gam2_64 = jnp.asarray(gam2, dtype=jnp.float64)
    gamw_64 = jnp.asarray(gamw, dtype=jnp.float64)
    tr_qinv = T + (dm.mt - n64) / gam2_64
    tr_ata_qinv = (n64 - gam2_64 * T) / gamw_64
    alpha2 = gam2 * tr_qinv / dm.mt
    eta2 = gam2 / alpha2
    gam1_new = _clamp(eta2 - gam2)
    gam1_new = rho * gam1_new + (1.0 - rho) * gam1
    r1_new = (c(eta2) * x2_hat - c(gam2) * r2) / c(gam1_new)

    dev1 = r1_new - sqrt_n_c * ts
    gam1_true = dm.mt / jnp.dot(dev1, dev1).astype(jnp.float64)

    resid = z2 - y_raw
    gamw_new = dm.n / (jnp.dot(resid, resid).astype(jnp.float64) + tr_ata_qinv)

    x2_corr, _ = signal_metrics(x2_hat, ts, dm.n)
    r2_lmmse, corr_y2_lmmse = prediction_metrics(z2, y_raw)

    metrics = jnp.stack(
        [r2_den, x1_corr, r2_lmmse, x2_corr, corr_y2_den, corr_y2_lmmse]
    )

    dx = x1_hat - x1_hat_prev
    denom = jnp.dot(x1_hat_prev, x1_hat_prev).astype(jnp.float64)
    nmse = jnp.where(
        denom > 0.0,
        jnp.sqrt(jnp.dot(dx, dx).astype(jnp.float64) / jnp.where(denom > 0.0, denom, 1.0)),
        jnp.inf,
    )

    return dict(
        nmse=nmse,
        x1_hat=x1_hat,
        alpha1=alpha1,
        eta1=eta1,
        z1=z1,
        gam2=gam2,
        r2=r2,
        x2_hat=x2_hat,
        alpha2=alpha2,
        eta2=eta2,
        gam1=gam1_new,
        r1=r1_new,
        gamw=gamw_new,
        cg_iters=jnp.asarray(0),
        cg_rel_err=jnp.zeros((2,), dtype=jnp.float64),
        metrics=metrics,
        gam1_true=gam1_true,
        gam2_true=gam2_true,
    )


def choose_lmmse_solver(cfg: RunConfig, mt: int, n: int, n_devices: int = 1) -> str:
    """Resolve cfg.lmmse_solver: "auto" picks the spectral path when the
    one-time Gram build (M·N^2 FLOPs, N^2 memory) is clearly amortized
    by the run — the wide-M regime the framework targets.  On a multi-chip
    mesh "auto" upgrades to the eigen path: its per-iteration dense work is
    two N^2 matvecs instead of the replicated 2N^3/3 factor, which is the
    Amdahl term that otherwise caps scaling (SCALING.md); the extra
    once-per-dataset diagonalization (~seconds) amortizes immediately at
    production iteration counts.  A WARM --eigen-cache upgrades single-chip
    auto too: the build cost is a file load, and eigen's per-iteration
    dense work (two N^2 matvecs) strictly beats the spectral factor's
    2N^3/3 FLOPs.

    Multi-chip auto requires the SAME warm cache (round-3 review, Weak #2):
    the diagonalization is a few seconds of FLOPs but ~60 compiles on a
    cold compilation cache, and silently charging that to a user's first
    mesh run before iteration 1 is a footgun.  Cold multi-chip
    runs get spectral (still exact, still psum-structured) plus a logged
    hint; `--lmmse-solver eigen` or a warmed `--eigen-cache` opts into the
    scaling-optimal path explicitly."""
    s = cfg.lmmse_solver
    if s != "auto":
        return s
    if n <= cfg.spectral_max_n and n >= 2048 and mt >= 4 * n:
        if cfg.eigen_cache and _cache_plausible(cfg.eigen_cache, n):
            return "eigen"
        if n_devices > 1 and jax.process_index() == 0:
            print(
                "auto LMMSE solver: picked spectral on a cold "
                f"{n_devices}-device mesh — warm an --eigen-cache (or pass "
                "--lmmse-solver eigen) to switch the per-iteration dense "
                "work from the replicated 2N^3/3 factor to two N^2 matvecs "
                "(SCALING.md)",
                flush=True,
            )
        return "spectral"
    return "cg"


def warn_em_stability(cfg: RunConfig, mt: int, n: int) -> bool:
    """One-line stderr warning when the EM hyperparameter updates are on in
    a regime where they are MEASURED to collapse (EM_STABILITY.json: every
    M/N >= 16 case except the smallest N diverged — engine and f64 numpy
    oracle alike, so the instability is algorithmic and inherited from the
    reference's gamw/prior EM, src/vamp.cpp:531-643).  The reference's own
    remedy is its documented Gibbs warm-start workflow (README.md:170-213),
    which this framework spells `--init-conf` (+ the Gibbs sampler /
    scripts/conf_gibbs_init.py); `--learn-prior-delay` and `--learn-vars 0`
    are the blunter instruments.  Returns True when the warning fired
    (tested); printing is rank-0 only."""
    risky = bool(cfg.learn_vars) and n > 0 and mt >= 16 * n
    if risky and jax.process_index() == 0:
        print(
            f"WARNING: EM prior/noise learning is ON at M/N = {mt / n:.0f} "
            "(>= 16), where the EM recursion is measured to collapse "
            "(EM_STABILITY.json) — consider --em-h2-budget 0.9 (truth-free "
            "signal-budget stabilizer, tools/em_stability.py 'budget' "
            "mode), a Gibbs warm start via --init-conf (see "
            "scripts/conf_gibbs_init.py), a longer --learn-prior-delay, "
            "or --learn-vars 0 with known variances",
            file=sys.stderr, flush=True,
        )
    return risky


def build_eigen_budgeted(fac, cfg, verbose):
    """build_eigen(_cached) under cfg.eigen_build_budget wall seconds
    (0 = unlimited).  Returns (EigenFactor, diag) or (None, None) on
    overrun — callers fall back to the spectral factor path, exactly like
    the residual-tolerance fallback (the run still completes, exactly,
    just without the amortized dense term)."""
    from ..ops.eigen import EigenBuildTimeout, build_eigen, build_eigen_cached

    deadline = (time.time() + cfg.eigen_build_budget
                if cfg.eigen_build_budget > 0 else None)
    try:
        if cfg.eigen_cache:
            return build_eigen_cached(fac, cfg.eigen_cache, seed=cfg.seed,
                                      deadline=deadline)
        return build_eigen(fac, seed=cfg.seed, deadline=deadline)
    except EigenBuildTimeout:
        _log(verbose, f"eigen build exceeded --eigen-build-budget "
                      f"{cfg.eigen_build_budget:.0f}s — falling back to the "
                      f"per-iteration spectral factor path")
        return None, None


def _cache_plausible(path: str, n: int) -> bool:
    """Cheap pre-check that an eigen cache file is a readable npz for this
    N — enough to justify the single-chip auto upgrade (the full
    fingerprint validation happens inside build_eigen_cached).  A corrupt
    or foreign file must NOT flip auto to eigen: that path was chosen
    precisely because the build cost is a file load."""
    import os

    if not os.path.exists(path):
        return False
    try:
        with np.load(path) as z:
            return "n" in z.files and int(z["n"]) == n
    except Exception:
        return False


def _log(verbose: bool, msg: str):
    if verbose and jax.process_index() == 0:
        print(msg, flush=True)


def infere_linear(
    dm: DesignMatrix,
    y: np.ndarray,
    cfg: RunConfig,
    true_signal: np.ndarray | None = None,
    x1hat_init: np.ndarray | None = None,
    covariates: np.ndarray | None = None,
    write_outputs: bool = True,
) -> LinearResult:
    """Run linear gVAMP.  `y`, `true_signal`, `x1hat_init` are host arrays in
    file units; `dm` is the (possibly mesh-sharded) design operator."""
    from ..prior.mixture import init_prior

    M_pad = dm.m_pad
    Mt = int(dm.mt)
    N = int(dm.n)
    sqrt_n = float(np.sqrt(N))
    wd = dm.wd
    # the reference narrates hyperparameters unconditionally (rank 0);
    # --verbosity 1 additionally compiles in the per-CG / per-EM residual
    # prints (src/vamp.cpp:615-617, 723-724, 747-748) via the phases' debug flag
    verbose = True

    def pad_m(vec):
        out = np.zeros(M_pad, dtype=np.float64)
        if vec is not None:
            out[: len(vec)] = vec
        return jnp.asarray(out, dtype=wd)

    ts = pad_m(true_signal)
    # Warm-start init follows the reference's written intent
    # (src/vamp.cpp:70-79, SURVEY Q1): x1_hat = r1 = x1hat_init / sqrt(N).
    init_vec = pad_m(np.asarray(x1hat_init) / sqrt_n if x1hat_init is not None else None)
    x1_hat = init_vec
    r1 = init_vec

    y_raw = jnp.asarray(np.asarray(y, dtype=np.float64), dtype=wd)
    y_adj = y_raw

    prior = init_prior(cfg.probs, cfg.vars, N)
    # STRONG f64 scalars: the loop feeds back jit outputs (strong f64);
    # a weak-typed initial value would give iteration 1 a different
    # phase aval than iteration 2+ — one full extra compile paid by every
    # run (tests/test_engine_linear.py counts the compiles)
    gam1 = jnp.asarray(float(cfg.gam1), dtype=jnp.float64)
    gamw = jnp.asarray(1.0 / (1.0 - cfg.h2), dtype=jnp.float64)  # src/main_meth.cpp:52
    rho = jnp.asarray(float(cfg.rho), dtype=jnp.float64)
    mu_warm = jnp.zeros(M_pad, dtype=wd)  # matches x2_hat's signature: no it-2 recompile
    key = jax.random.PRNGKey(cfg.seed)
    it_start = 1

    # covariate adjustment, once (src/vamp.cpp:153-169)
    cov_eff = None
    if cfg.C > 0 and covariates is not None and covariates.shape[1] > 0:
        from ..glm.probit import newton_method_cov

        cov_eff = newton_method_cov(
            np.asarray(y), np.zeros(N), covariates, np.zeros(cfg.C),
            probit_var=cfg.probit_var, verbosity=cfg.verbosity,
        )
        y_adj = jnp.asarray(np.asarray(y) - covariates @ cov_eff, dtype=wd)

    # exact-state resume (extension, SURVEY §5.4)
    if cfg.resume_file:
        from .checkpoint import check_meta, load_checkpoint, restore_key

        ck = load_checkpoint(cfg.resume_file)
        check_meta(ck, model="linear", mt=Mt, n=N, m_pad=M_pad)
        a = ck["arrays"]
        x1_hat = jnp.asarray(a["x1_hat"], dtype=wd)
        r1 = jnp.asarray(a["r1"], dtype=wd)
        mu_warm = jnp.asarray(a["mu_warm"], dtype=wd)
        if "y_adj" in a:
            y_adj = jnp.asarray(a["y_adj"], dtype=wd)
        gam1 = jnp.asarray(ck["scalars"]["gam1"], dtype=jnp.float64)
        gamw = jnp.asarray(ck["scalars"]["gamw"], dtype=jnp.float64)
        prior = MixturePrior(
            probs=jnp.asarray(ck["prior"]["probs"]),
            vars=jnp.asarray(ck["prior"]["vars"]),
            active=jnp.asarray(ck["prior"]["active"]),
        )
        key = restore_key(ck["rng_key"])
        it_start = ck["iteration"] + 1
        _log(verbose, f"...resumed exact state from {cfg.resume_file} at iteration {it_start}")

    (x1_hat, r1, mu_warm), (gam1, gamw, prior) = commit_like(
        dm.X, (x1_hat, r1, mu_warm), (gam1, gamw, prior))

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
            # resuming into the same out_dir must APPEND to the positional
            # rows written before the crash, not delete and recreate them
            fresh = (not cfg.resume_file) or not _os.path.exists(path)
            return PositionalCSV(path, header, create=fresh)

        out_metrics = _csv(base + "_metrics.csv", METRICS_HEADER)
        out_params = _csv(base + "_params.csv", PARAMS_HEADER)
        out_prior = _csv(base + "_prior.csv", prior_header)

    # LMMSE solver choice (run-level static): exact spectral/eigen path or CG
    n_devices = 1
    if isinstance(dm.X.sharding, NamedSharding):
        n_devices = int(np.prod(dm.X.sharding.mesh.devices.shape))
    solver = choose_lmmse_solver(cfg, Mt, N, n_devices)
    warn_em_stability(cfg, Mt, N)
    fac = None
    ef = None
    setup = {}
    # every jit that reads X compiles under the design's options
    aty_adj = jit_for_design(atx, dm)(dm, y_adj)  # constant across iterations
    if solver in ("spectral", "eigen"):
        t_fac = time.time()
        fac = build_spectral(dm)
        jax.block_until_ready(fac.K)
        setup["gram_s"] = time.time() - t_fac
        _log(verbose, f"spectral LMMSE factor built in {setup['gram_s']:.3f}s "
                      f"(N={N}; exact solves + exact Onsager from here on)")
    if solver == "eigen":
        t_eig = time.time()
        ef, eig_diag = build_eigen_budgeted(fac, cfg, verbose)
        setup["eigen_s"] = time.time() - t_eig
        if ef is None:
            solver = "spectral"
        else:
            setup["eigen_resid"] = float(eig_diag["resid"])
            _log(verbose, f"eigenbasis of K "
                          f"{'loaded' if eig_diag.get('loaded') else 'built'} "
                          f"in {setup['eigen_s']:.3f}s "
                          f"(residual {eig_diag['resid']:.2e}, "
                          f"{eig_diag['splits']} sign splits)")
            if eig_diag["resid"] > 1e-3:
                _log(verbose, "eigen residual above tolerance — falling back "
                              "to the per-iteration factor path")
                solver, ef = "spectral", None

    from ..utils.telemetry import Tracer

    tracer = Tracer(
        path=(f"{cfg.out_dir}/{cfg.out_name}_trace.jsonl"
              if write_outputs and cfg.trace else None),
        model="linear",
        solver=solver,
    )
    # bytes per MATRIX ELEMENT an HBM pass moves: 0.5 for the packed
    # int4 layout (two codes per byte), else the storage itemsize
    itemsize = (0.5 if dm.X.dtype == jnp.uint8
                else jnp.dtype(dm.X.dtype).itemsize)

    # device→host artifact IO overlaps the next iteration's compute (see
    # utils/async_writer.py)
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

    y_adj_host = (
        fetch_global(y_adj).astype(np.float64) if cfg.checkpoint_file else None
    )  # constant across iterations: fetch/gather once, not per checkpoint

    def _save_ckpt(k, x1_dev, r1_dev, mu_dev, gam1_k, gamw_k, prior_k, key_k):
        from .checkpoint import save_checkpoint

        save_checkpoint(
            cfg.checkpoint_file,
            iteration=k,
            arrays=dict(
                x1_hat=fetch_global(x1_dev).astype(np.float64),
                r1=fetch_global(r1_dev).astype(np.float64),
                mu_warm=fetch_global(mu_dev).astype(np.float64),
                y_adj=y_adj_host,
            ),
            scalars=dict(gam1=gam1_k, gamw=gamw_k),
            prior=prior_k,
            key=key_k,
            meta=dict(model="linear", mt=Mt, n=N, m_pad=M_pad),
        )

    metrics_history = []
    it_done = 0

    try:
        for it in range(it_start, cfg.iterations + 1):
            t0 = time.time()
            tracer.start()
            _log(verbose, f"\n********************\niteration = {it}\n********************")

            # EM prior update + merge, fully on device (src/vamp.cpp:186-187)
            if it > cfg.learn_prior_delay:
                prior = _em_phase(
                    dm, r1, gam1, prior,
                    jnp.asarray(cfg.EM_max_iter), jnp.asarray(cfg.EM_err_thr),
                    jnp.asarray(bool(cfg.learn_vars)), jnp.asarray(cfg.merge_vars_thr),
                    jnp.asarray(cfg.em_signal_budget(N), dtype=jnp.float64),
                    debug=cfg.verbosity == 1,
                )

            # fresh Rademacher trace probe (seeded; fixes reference quirk Q4).
            # The key is split every iteration regardless of solver so checkpoints
            # taken under either solver resume with an identical RNG stream.
            key, sub = jax.random.split(key)

            x1_prev = x1_hat
            r1_in = r1  # the r1 this iteration denoises; dumped to _r1_it_<k>.bin
            if solver == "eigen":
                out = jit_for_design(_iteration_phase_eigen, dm)(
                    dm, ef, aty_adj, y_raw, r1, gam1, prior, x1_prev,
                    jnp.asarray(it > 1), rho, gamw, ts,
                )
            elif solver == "spectral":
                out = jit_for_design(_iteration_phase_spectral, dm)(
                    dm, fac, aty_adj, y_raw, r1, gam1, prior, x1_prev,
                    jnp.asarray(it > 1), rho, gamw, ts,
                )
            else:
                bern = (
                    jax.random.rademacher(sub, (M_pad,), dtype=wd)
                    * jnp.asarray(1.0 / np.sqrt(float(Mt)), dtype=wd)
                ) * dm.mmask
                out = jit_for_design(_iteration_phase, dm, ("debug",))(
                    dm, aty_adj, y_raw, r1, gam1, prior, x1_prev,
                    jnp.asarray(it > 1), rho, gamw, mu_warm, bern, ts,
                    jnp.asarray(cfg.CG_max_iter), jnp.asarray(cfg.CG_err_tol),
                    debug=cfg.verbosity == 1,
                )

            x1_hat = out["x1_hat"]
            mu_warm = out["x2_hat"]  # CG warm start (src/vamp.cpp:308-311, 753-754)
            r1 = out["r1"]
            gam1_denoise = float(gam1)  # params CSV records the pre-LMMSE gam1
            gam1 = out["gam1"]
            gamw = out["gamw"]

            # one batched fetch of every O(1) output (each separate float() is
            # its own host round trip)
            host, prior_h = jax.device_get(
                ({k: out[k] for k in (
                    "alpha1", "alpha2", "gam2", "gam1", "gamw",
                    "gam1_true", "gam2_true", "cg_iters", "metrics", "nmse",
                )}, prior)
            )

            # per-iteration artifacts (src/vamp.cpp:234-252): x1_hat/sqrt(N) and
            # the r1 that was denoised this iteration — fetched and written on the
            # IO thread, overlapping the next iteration's compute
            if write_outputs:
                writer.submit(_dump_iteration, it, x1_hat, r1_in)

            metrics = np.asarray(host["metrics"])
            metrics_history.append(metrics)
            params_row = [
                float(host["alpha1"]), gam1_denoise,
                float(host["alpha2"]), float(host["gam2"]), float(host["gamw"]),
            ]
            if write_outputs:
                out_params.write_row(it, params_row)
                out_metrics.write_row(it, metrics.tolist())
                act = np.asarray(prior_h.active)
                pr = np.asarray(prior_h.probs)[act]
                vr = np.asarray(prior_h.vars)[act] / N
                out_prior.write_row(it, [float(len(pr))] + pr.tolist() + vr.tolist())

            _log(verbose, f"alpha1 = {float(host['alpha1'])}")
            _log(verbose, f"gam1 = {gam1_denoise}")
            _log(verbose, f"gam2 = {float(host['gam2'])}  (true {float(host['gam2_true'])})")
            _log(verbose, f"alpha2 = {float(host['alpha2'])}")
            _log(verbose, f"new gam1 = {float(host['gam1'])}  (true {float(host['gam1_true'])})")
            _log(verbose, f"gamw = {float(host['gamw'])}")
            _log(verbose, f"CG iters = {int(host['cg_iters'])}")
            _log(verbose, f"metrics [R2_den, x1corr, R2_lmmse, x2corr, zcorr2_den, zcorr2_lmmse] = {metrics}")

            rec = tracer.stop(
                it, int(host["cg_iters"]), M_pad, N, itemsize,
                gam1=float(host["gam1"]), gamw=float(host["gamw"]),
            )
            _log(verbose, f"iteration time = {rec.seconds:.3f}s  "
                          f"(~{rec.matrix_passes} matrix passes, {rec.gbps:.1f} GB/s)  "
                          f"total = {tracer.total_comp_time:.3f}s")

            if cfg.checkpoint_file:
                writer.submit(
                    _save_ckpt, it,
                    _materialize(x1_hat), _materialize(r1), _materialize(mu_warm),
                    float(host["gam1"]), float(host["gamw"]), prior, key,
                )

            it_done = it

            # stopping criterion (src/vamp.cpp:405-423), computed on device
            nmse = float(host["nmse"])
            # nmse is inf when x1_hat_prev == 0 (cold start): narrate that
            # case readably instead of printing "inf"
            _log(verbose, f"x1_hat NMSE = {nmse if np.isfinite(nmse) else 'n/a (zero previous iterate)'}")
            if it > 1 and nmse < cfg.stop_criteria_thr:
                _log(verbose, "...stopping criteria fulfilled")
                break

    finally:
        writer.close()  # artifacts durably on disk even on error paths
    x1_scaled = fetch_global(x1_hat).astype(np.float64)[:Mt] / sqrt_n

    act = np.asarray(prior.active)
    return LinearResult(
        x1_hat_scaled=x1_scaled,
        iterations_run=it_done,
        gam1=float(gam1),
        gamw=float(gamw),
        probs=np.asarray(prior.probs)[act],
        vars=np.asarray(prior.vars)[act],
        metrics_history=metrics_history,
        r1_scaled=fetch_global(r1).astype(np.float64)[:Mt] / sqrt_n,
        iter_seconds=[r.seconds for r in tracer.records],
        setup=setup,
    )

"""Production-scale OUT-OF-SAMPLE evidence — train/held-out split, linear
AND probit (VERDICT round-4 ask #5).

Every prior PRODUCTION_RUN entry scored in-sample or against truth; the
reference's own large-scale path builds a train/test split
(/root/reference/simulation/sim_top_iid.py:53-66) and replays saved
iterates against the held-out rows (`test` run mode,
src/main_meth.cpp:112-205; probit confusion/accuracy,
src/main_meth_probit.cpp:160-199).  This tool drives that exact workflow
through the framework at the 17 GB production shape:

  1. simulate ONE (n_train + n_test) x M dataset, split rows by a random
     mask (the sim_top_iid construction), write train and test
     .bin/.phen fixtures;
  2. linear: truth-free calibrated prior (prior/marginal.py
     estimate_linear_prior) -> fixed-prior gVAMP on the TRAIN rows with
     per-iteration estimate dumps -> `test` mode over the saved
     iteration range on the HELD-OUT rows (run_test_linear; estimates
     rescaled by sqrt(N_test), R2 against the test-set variance —
     the reference's formula);
  3. probit: liability labels from the same X and beta, truth-free
     calibrated probit prior (estimate_probit_prior) -> fixed-prior
     GLM-VAMP on train -> held-out confusion/accuracy per saved
     iteration (run_test_probit) — the only honest probit quality
     metric at M >> N (in-sample accuracy is 1.0 by separation alone);
  4. append everything under "oos_r05" in PRODUCTION_RUN.json.

Outage-proofing (the gibbs_production lesson): OOS_PARTIAL.json at the
repo root is rewritten after EVERY stage, so a timeout or device failure
loses at most the stage in flight; the final merge into
PRODUCTION_RUN.json removes the partial file.

Usage: python tools/oos_production.py [--small]   (--small: CPU smoke)
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)

SMALL = "--small" in sys.argv

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tools.production_run import write_conf  # noqa: E402
from vampomi_tpu.cli import load_init_conf  # noqa: E402
from vampomi_tpu.config import RunConfig  # noqa: E402
from vampomi_tpu.dataset import load_dataset  # noqa: E402
from vampomi_tpu.engine.linear import infere_linear  # noqa: E402
from vampomi_tpu.engine.probit import infere_bin_class  # noqa: E402
from vampomi_tpu.modes.test_mode import run_test_linear, run_test_probit  # noqa: E402
from vampomi_tpu.ops.operator import atx  # noqa: E402
from vampomi_tpu.prior.marginal import (  # noqa: E402
    estimate_linear_prior,
    estimate_probit_prior,
)
from vampomi_tpu.sim.data_sim import Fixture, write_fixture  # noqa: E402

PARTIAL = os.path.join(_ROOT, "OOS_PARTIAL.json")


def checkpoint(out, stage):
    out["last_stage_done"] = stage
    with open(PARTIAL, "w") as f:
        json.dump(out, f, indent=1)
    print(f"[oos] stage done: {stage}", flush=True)


def main():
    if SMALL:
        jax.config.update("jax_platforms", "cpu")
    m = 8192 if SMALL else 262144
    n_tr = 512 if SMALL else 8192
    n_te = 128 if SMALL else 2048
    lam_true, h2_true = 0.002, 0.8
    iters = 8 if SMALL else 20
    seed = 31

    out = {"shape": dict(M=m, N_train=n_tr, N_test=n_te, dtype="int8",
                         solver="eigen"),
           "truth_for_reference": dict(lam=lam_true, h2=h2_true)}

    # ---- 1. simulate once, split rows (sim_top_iid.py:53-66) ----
    t0 = time.time()
    n_tot = n_tr + n_te
    rng = np.random.default_rng(seed)
    X = rng.normal(0.0, 1.0, size=(n_tot, m))
    cm = int(m * lam_true)
    beta = np.zeros(m)
    beta[rng.choice(m, size=cm, replace=False)] = rng.normal(
        0.0, np.sqrt(h2_true / cm), cm)
    g = X @ beta
    y_lin = g + rng.normal(0.0, np.sqrt(1.0 - h2_true), n_tot)
    # probit labels from the population-standardized liability (unit-noise
    # threshold model, the src/vamp_probit.cpp likelihood)
    Xs = (X - X.mean(axis=0)) / X.std(axis=0, ddof=1)
    z_lia = Xs @ beta
    y_bin = (z_lia + rng.normal(size=n_tot) > 0).astype(np.float64)
    del Xs, z_lia, g

    mask = np.zeros(n_tot, dtype=bool)
    mask[rng.choice(n_tot, size=n_te, replace=False)] = True  # test rows
    workdir = tempfile.mkdtemp(prefix="oos_r05_")
    files_tr = write_fixture(Fixture(X=X[~mask], beta=beta, y=y_lin[~mask]),
                             workdir, "tr")
    files_te = write_fixture(Fixture(X=X[mask], beta=beta, y=y_lin[mask]),
                             workdir, "te")
    for tag, yb in (("tr", y_bin[~mask]), ("te", y_bin[mask])):
        with open(os.path.join(workdir, f"{tag}_bin.phen"), "w") as f:
            for i, v in enumerate(yb):
                f.write(f"F{i} I{i} {int(v)}\n")
    del X
    out["sim_and_write_seconds"] = round(time.time() - t0, 1)
    out["meth_bytes"] = dict(train=os.path.getsize(files_tr["bin"]),
                             test=os.path.getsize(files_te["bin"]))
    out["case_fraction"] = dict(train=float(y_bin[~mask].mean()),
                                test=float(y_bin[mask].mean()))
    out["workdir"] = workdir
    checkpoint(out, "simulate_split")

    eigen_cache = os.path.join(workdir, "tr_eigen.npz")
    common = dict(
        out_dir=workdir, meth_file=files_tr["bin"], gam1=1e-6,
        stop_criteria_thr=0.0, seed=7, trace=0, lmmse_solver="eigen",
        compute_dtype="int8", CG_max_iter=500, CG_err_tol=1e-5,
        eigen_cache=eigen_cache,
    )

    # ======================= LINEAR =======================
    t0 = time.time()
    ds = load_dataset(files_tr["bin"], files_tr["phen"], n=n_tr, mt=m,
                      model="linear", mesh=None, compute_dtype=jnp.int8)
    y_std = jnp.asarray(ds.phen.y, dtype=ds.dm.wd)
    # A's columns are centered, so A^T y == A^T y_centered
    bhat = np.asarray(jax.device_get(jax.jit(atx)(ds.dm, y_std)),
                      dtype=np.float64)[:m]
    yc = ds.phen.y - ds.phen.y.mean()
    est = estimate_linear_prior(bhat, n_tr, y_ss=float(yc @ yc))
    conf_path = os.path.join(workdir, "oos_lin.conf")
    write_conf(conf_path, est["lam"], est["var_file"], est["h2"], rho=0.5)
    conf = load_init_conf(conf_path)
    out["linear"] = {"prior_estimate": dict(
        lam_hat=est["lam"], h2_hat=est["h2"],
        estimator="prior/marginal.py estimate_linear_prior")}
    print(f"[oos] linear prior: lam={est['lam']:.4g} h2={est['h2']:.3f} "
          f"(truth {lam_true}/{h2_true})", flush=True)

    cfg = RunConfig(iterations=iters, learn_prior_delay=iters + 1,
                    out_name="oos", model="linear", probs=conf["probs"],
                    vars=conf["vars"], h2=conf["h2"], rho=conf["rho"],
                    **common)
    res = infere_linear(ds.dm, ds.phen.y, cfg, true_signal=beta,
                        write_outputs=True)
    corr = float(np.corrcoef(res.x1_hat_scaled, beta)[0, 1])
    mrow = [float(v) for v in res.metrics_history[-1]]
    out["linear"]["train_run"] = dict(
        iterations=res.iterations_run, wall_seconds=round(time.time() - t0, 1),
        corr_vs_truth=corr, in_sample_r2=mrow[0],
        final_metrics_row=mrow)
    checkpoint(out, "linear_train")
    print(f"[oos] linear train: corr={corr:.4f} "
          f"in-sample R2={mrow[0]:.4f}", flush=True)

    # held-out replay (reference test mode: rescale by sqrt(N_test),
    # R2 against test-set variance)
    t0 = time.time()
    ds_te = load_dataset(files_te["bin"], files_te["phen"], n=n_te, mt=m,
                         model="linear", mesh=None, compute_dtype=jnp.int8)
    tcfg = cfg.replace(
        N_test=n_te, out_name="oos", test_iter_range=(1, res.iterations_run),
        estimate_file=os.path.join(workdir, "oos_it_1.bin"))
    rows = run_test_linear(ds_te, tcfg)
    r2s = [r[0] for r in rows]
    out["linear"]["held_out"] = dict(
        wall_seconds=round(time.time() - t0, 1),
        r2_final=r2s[-1], r2_best=max(r2s),
        best_iteration=int(np.argmax(r2s) + 1),
        corr2_final=rows[-1][1],
        r2_by_iteration=[round(v, 4) for v in r2s],
        csv=os.path.join(workdir, "oos_test.csv"))
    checkpoint(out, "linear_held_out")
    print(f"[oos] linear HELD-OUT: final R2={r2s[-1]:.4f} "
          f"best={max(r2s):.4f} (true h2={h2_true})", flush=True)

    # ======================= PROBIT =======================
    t0 = time.time()
    phen_trp = os.path.join(workdir, "tr_bin.phen")
    dsp = load_dataset(files_tr["bin"], phen_trp, n=n_tr, mt=m,
                       model="bin_class", mesh=None, compute_dtype=jnp.int8)
    ybin_tr = dsp.phen.y
    ycp = jnp.asarray(ybin_tr - ybin_tr.mean(), dtype=dsp.dm.wd)
    bhat_p = np.asarray(jax.device_get(jax.jit(atx)(dsp.dm, ycp)),
                        dtype=np.float64)[:m]
    estp = estimate_probit_prior(bhat_p, n_tr, float(ybin_tr.mean()))
    conf_path_p = os.path.join(workdir, "oos_probit.conf")
    write_conf(conf_path_p, estp["lam"], estp["var_file"], estp["h2"],
               rho=0.5)
    confp = load_init_conf(conf_path_p)
    out["probit"] = {"prior_estimate": dict(
        lam_hat=estp["lam"], h2_hat=estp["h2"],
        estimator="prior/marginal.py estimate_probit_prior")}
    print(f"[oos] probit prior: lam={estp['lam']:.4g} h2={estp['h2']:.3f}",
          flush=True)

    cfgp = RunConfig(iterations=iters, learn_prior_delay=iters + 1,
                     out_name="oosp", model="bin_class",
                     probs=confp["probs"], vars=confp["vars"],
                     h2=confp["h2"], rho=confp["rho"], **common)
    resp = infere_bin_class(dsp.dm, ybin_tr, cfgp, true_signal=beta,
                            write_outputs=True)
    corr_p = float(np.corrcoef(resp.x1_hat_scaled, beta)[0, 1])
    mrow_p = [float(v) for v in resp.metrics_history[-1]]
    out["probit"]["train_run"] = dict(
        iterations=resp.iterations_run,
        wall_seconds=round(time.time() - t0, 1),
        corr_vs_truth=corr_p, in_sample_accuracy=mrow_p[4],
        final_metrics_row=mrow_p)
    checkpoint(out, "probit_train")
    print(f"[oos] probit train: corr={corr_p:.4f} in-sample "
          f"acc={mrow_p[4]:.4f}", flush=True)

    t0 = time.time()
    phen_tep = os.path.join(workdir, "te_bin.phen")
    dsp_te = load_dataset(files_te["bin"], phen_tep, n=n_te, mt=m,
                          model="bin_class", mesh=None,
                          compute_dtype=jnp.int8)
    tcfgp = cfgp.replace(
        N_test=n_te, out_name="oosp",
        test_iter_range=(1, resp.iterations_run),
        estimate_file=os.path.join(workdir, "oosp_it_1.bin"))
    rows_p = run_test_probit(dsp_te, tcfgp)
    accs = [r[4] for r in rows_p]
    tp, tn, fp, fn, acc = rows_p[-1]
    out["probit"]["held_out"] = dict(
        wall_seconds=round(time.time() - t0, 1),
        accuracy_final=acc, accuracy_best=max(accs),
        best_iteration=int(np.argmax(accs) + 1),
        confusion_final=dict(tp=int(tp), tn=int(tn), fp=int(fp), fn=int(fn)),
        accuracy_by_iteration=[round(v, 4) for v in accs],
        base_rate=max(out["case_fraction"]["test"],
                      1.0 - out["case_fraction"]["test"]),
        csv=os.path.join(workdir, "oosp_test.csv"))
    checkpoint(out, "probit_held_out")
    print(f"[oos] probit HELD-OUT: final acc={acc:.4f} best={max(accs):.4f} "
          f"base rate={out['probit']['held_out']['base_rate']:.3f}",
          flush=True)

    out["note"] = (
        "Train/held-out split at the production shape, both model families, "
        "truth-free calibrated priors (truth used for scoring only).  "
        "Held-out linear R2 is bounded by h2=0.8 minus the estimation gap; "
        "held-out probit accuracy is the honest quality metric at M>>N "
        "(train accuracy 1.0 is separation, not skill).  Reference parity: "
        "test mode src/main_meth.cpp:112-205 (rescale sqrt(N_test), R2 vs "
        "sigma_y^2), probit confusion src/main_meth_probit.cpp:160-199, "
        "split construction simulation/sim_top_iid.py:53-66.")

    key = "oos_small" if SMALL else "oos_r05"
    prod_path = os.path.join(_ROOT, "PRODUCTION_RUN.json")
    if not SMALL:
        with open(prod_path) as f:
            prod = json.load(f)
        prod[key] = out
        with open(prod_path, "w") as f:
            json.dump(prod, f, indent=1)
        os.remove(PARTIAL)
        print(f"[oos] appended '{key}' to PRODUCTION_RUN.json", flush=True)
    else:
        if os.path.exists(PARTIAL):
            os.remove(PARTIAL)
        print(json.dumps(out, indent=1), flush=True)


if __name__ == "__main__":
    main()

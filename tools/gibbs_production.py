"""Production-scale run of the COMPLETE documented warm-start workflow:

    Gibbs sampler  ->  conf_gibbs_init  ->  --init-conf  ->  gVAMP

(reference README.md:170-213).  Unlike em_credible_r03 — which substituted a
one-pass marginal-moment estimate for the MCMC stage — this drives the
framework's own Gibbs sampler (vampomi_tpu/gibbs/) at production
scale, feeds its CSV/.grm through the ported conf_gibbs_init script
verbatim, and seeds inference from the emitted .conf.  No ground truth
enters inference at any stage; truth is used only to SCORE afterwards.

Usage: python tools/gibbs_production.py [--small]
Appends "gibbs_warmstart_r04" to PRODUCTION_RUN.json.
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

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import vampomi_tpu.scripts.conf_gibbs_init as cgi  # noqa: E402
from vampomi_tpu.cli import load_init_conf  # noqa: E402
from vampomi_tpu.config import RunConfig  # noqa: E402
from vampomi_tpu.dataset import load_dataset  # noqa: E402
from vampomi_tpu.engine.linear import infere_linear  # noqa: E402
from vampomi_tpu.gibbs import run_gibbs  # noqa: E402
from vampomi_tpu.modes.association import run_association_test  # noqa: E402
from vampomi_tpu.sim.data_sim import simulate_iid, write_fixture  # noqa: E402


def main():
    small = "--small" in sys.argv
    if small:
        jax.config.update("jax_platforms", "cpu")
    n, m = (512, 8192) if small else (8192, 262144)
    lam_true, h2_true = 0.002, 0.8
    sweeps = 60 if small else 400
    iters = 8 if small else 25
    seed = 29

    out = {"shape": dict(M=m, N=n, dtype="int8", solver="eigen",
                         gibbs_sweeps=sweeps)}
    fx = simulate_iid(n=n, m=m, lam=lam_true, h2=h2_true, seed=seed)
    workdir = tempfile.mkdtemp(prefix="prod_gibbs_r04_")
    files = write_fixture(fx, workdir, "prodg")

    t0 = time.time()
    ds = load_dataset(files["bin"], files["phen"], n=n, mt=m, model="linear",
                      mesh=None, compute_dtype=jnp.int8)
    out["ingest_seconds"] = round(time.time() - t0, 1)

    # ---- stage 1: the framework's Gibbs sampler (truth-free) ----
    t0 = time.time()
    res_g = run_gibbs(
        ds.dm, ds.phen.y, iterations=sweeps, burnin=sweeps // 2,
        l_comp=4, block=256, thin=10,  # .bet unused here (conf needs CSV+grm only)
        h2_init=0.5, seed=5,
        out_dir=workdir, out_name="mcmc",
    )
    gibbs_secs = time.time() - t0
    corr_gibbs = float(np.corrcoef(res_g.x_mean_file, fx.beta)[0, 1])
    causal = np.abs(fx.beta) > 0
    out["gibbs"] = dict(
        wall_seconds=round(gibbs_secs, 1),
        seconds_per_sweep=round(gibbs_secs / sweeps, 3),
        h2_mean=res_g.h2_mean, sigma_g_mean_file=res_g.sigma_g_mean,
        lambda_mean=float(1.0 - res_g.pi_mean[0]),
        posterior_mean_corr_vs_truth=corr_gibbs,
        pip_causal_mean=float(res_g.pip[causal].mean()),
        pip_null_mean=float(res_g.pip[~causal].mean()),
        truth_for_reference=dict(lam=lam_true, h2=h2_true),
    )
    print(f"gibbs: {gibbs_secs:.0f}s ({gibbs_secs/sweeps:.2f}s/sweep) "
          f"h2={res_g.h2_mean:.3f} lam={1-res_g.pi_mean[0]:.4g} "
          f"postmean corr={corr_gibbs:.4f}", flush=True)

    # ---- stage 2: conf_gibbs_init, the PORTED SCRIPT, verbatim ----
    conf_path = cgi.main([
        "-csv", res_g.csv_path, "-grm", res_g.grm_path,
        "-out_dir", workdir, "-iterations", f"{sweeps // 2}:{sweeps}",
    ])
    conf = load_init_conf(conf_path)
    out["conf"] = conf

    # ---- stage 3: gVAMP seeded from the .conf, prior fixed ----
    t0 = time.time()
    cfg = RunConfig(
        out_dir=workdir, out_name="prodg", meth_file=files["bin"],
        probs=conf["probs"], vars=conf["vars"], h2=conf["h2"],
        rho=conf["rho"], gam1=1e-6, stop_criteria_thr=0.0, seed=7,
        trace=0, lmmse_solver="eigen", compute_dtype="int8",
        iterations=iters, learn_prior_delay=iters + 1,
        CG_max_iter=500, CG_err_tol=1e-5,
    )
    res = infere_linear(ds.dm, ds.phen.y, cfg, true_signal=fx.beta,
                        write_outputs=True)
    secs = time.time() - t0
    corr = float(np.corrcoef(res.x1_hat_scaled, fx.beta)[0, 1])
    out["vamp_run"] = dict(
        iterations=res.iterations_run, wall_seconds=round(secs, 1),
        final_metrics_row=[float(v) for v in res.metrics_history[-1]],
        corr_vs_truth=corr, gamw=float(res.gamw),
    )
    print(f"vamp from gibbs .conf: corr={corr:.4f} ({secs:.0f}s)", flush=True)

    # ---- SE association (truth only for scoring) ----
    it_last = res.iterations_run
    acfg = cfg.replace(
        N_test=n, Mt=m, pval_method="se",
        r1_file=os.path.join(workdir, f"prodg_r1_it_{it_last}.bin"),
        estimate_file=os.path.join(workdir, f"prodg_it_{it_last}.bin"),
        gam1=float(res.gam1), phen_file=files["phen"],
    )
    pvals = np.asarray(run_association_test(ds, acfg))
    thr = 0.05 / m
    sig = pvals < thr
    out["association_se"] = dict(
        bonferroni_threshold=thr,
        true_positives=int((sig & causal).sum()),
        false_positives=int((sig & ~causal).sum()),
        causal_markers=int(causal.sum()),
    )
    print(f"association SE: TP={out['association_se']['true_positives']} "
          f"FP={out['association_se']['false_positives']} of "
          f"{int(causal.sum())}", flush=True)

    out["note"] = (
        "The reference's full documented production workflow with every "
        "stage inside the framework: block-Gibbs (int8-exact "
        "block Grams, 2 X passes/sweep) -> conf_gibbs_init (ported script, "
        "verbatim) -> --init-conf -> eigen-LMMSE gVAMP with the MCMC-derived "
        "prior fixed.  Truth scores, never informs."
    )

    if small:
        # smoke configuration: never overwrite the production artifact
        print(json.dumps(out, indent=1))
    else:
        path = os.path.join(_ROOT, "PRODUCTION_RUN.json")
        try:
            full = json.load(open(path))
        except Exception:
            full = {}
        full["gibbs_warmstart_r04"] = out
        with open(path, "w") as f:
            json.dump(full, f, indent=1)
        print(f"wrote {path}")

    if "--keep" not in sys.argv:
        import shutil

        shutil.rmtree(workdir, ignore_errors=True)


if __name__ == "__main__":
    main()

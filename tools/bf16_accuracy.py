"""bf16-vs-f32 trajectory accuracy on the accelerator at a mid-size fixture.

Evidence for the claim that bf16 X (vectors f32) halves HBM per marker "at
equal rate" WITHOUT changing the science: runs the identical linear-gVAMP
inference twice (X in f32, X in bf16) on one chip and records the relative
trajectory differences of every params-CSV quantity plus the final
signal-recovery metrics.  Writes BF16_ACCURACY.json at the repo root.

Usage:  python tools/bf16_accuracy.py  [M N iterations]
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp  # noqa: E402

from vampomi_tpu.config import RunConfig  # noqa: E402
from vampomi_tpu.engine.linear import infere_linear  # noqa: E402
from vampomi_tpu.io.csv_writer import read_positional_csv  # noqa: E402
from vampomi_tpu.ops.operator import build_design  # noqa: E402
from vampomi_tpu.sim.data_sim import simulate_iid  # noqa: E402


def run_one(fx, dtype, cfg):
    dm = build_design(fx.X.T, mesh=None, compute_dtype=dtype)
    t0 = time.time()
    res = infere_linear(dm, fx.y, cfg, true_signal=fx.beta, write_outputs=True)
    dt = time.time() - t0
    params = read_positional_csv(
        os.path.join(cfg.out_dir, cfg.out_name + "_params.csv"))
    metrics = read_positional_csv(
        os.path.join(cfg.out_dir, cfg.out_name + "_metrics.csv"))
    return dict(
        params=params, metrics=metrics, seconds=dt,
        iters=res.iterations_run,
        final_corr=float(np.asarray(res.metrics_history[-1])[1]),
        gamw=res.gamw,
    )


def main():
    m = int(sys.argv[1]) if len(sys.argv) > 1 else 65536
    n = int(sys.argv[2]) if len(sys.argv) > 2 else 4096
    iters = int(sys.argv[3]) if len(sys.argv) > 3 else 10

    fx = simulate_iid(n=n, m=m, lam=0.01, h2=0.8, seed=7)
    out = {}
    runs = {}
    for name, dtype in (("float32", jnp.float32), ("bfloat16", jnp.bfloat16)):
        tmp = tempfile.mkdtemp(prefix=f"bf16acc_{name}_")
        cfg = RunConfig(
            out_dir=tmp, out_name="acc", iterations=iters, rho=0.5, h2=0.8,
            gam1=1e-6, probs=[0.99, 0.01], vars=[0.0, 0.8 / (m * 0.01)],
            # prior FIXED at truth (the production warm-start
            # workflow): this shape sits in the EM-metastable regime
            # (EM_STABILITY.json) where EM-on outcomes flip with any
            # fp-order change, which would confound the dtype
            # comparison this tool exists to isolate
            EM_max_iter=1, learn_vars=0, learn_prior_delay=99,
            merge_vars_thr=0.5, stop_criteria_thr=0.0, seed=7, meth_file="x",
            lmmse_solver="spectral",
        )
        print(f"--- running {name} at M={m} N={n} x{iters} iterations",
              flush=True)
        runs[name] = run_one(fx, dtype, cfg)
        out[name] = dict(
            seconds=runs[name]["seconds"],
            final_corr=runs[name]["final_corr"],
            gamw=runs[name]["gamw"],
        )

    # per-iteration relative differences of [alpha1, gam1, alpha2, gam2, gamw]
    cols = ["alpha1", "gam1", "alpha2", "gam2", "gamw"]
    p32 = np.asarray(runs["float32"]["params"])
    p16 = np.asarray(runs["bfloat16"]["params"])
    k = min(len(p32), len(p16))
    rel = np.abs(p16[:k, 1:6] - p32[:k, 1:6]) / np.maximum(np.abs(p32[:k, 1:6]), 1e-300)
    out["trajectory_rel_diff"] = {
        c: [float(v) for v in rel[:, i]] for i, c in enumerate(cols)
    }
    out["max_rel_diff"] = {c: float(rel[:, i].max()) for i, c in enumerate(cols)}
    out["corr_diff"] = abs(out["bfloat16"]["final_corr"] - out["float32"]["final_corr"])
    out["shape"] = dict(M=m, N=n, iterations=iters)
    out["claim"] = (
        "bf16 X halves HBM bytes per marker; trajectory stays within the "
        "recorded tolerances of the f32 run on the same chip"
    )

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "BF16_ACCURACY.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out["max_rel_diff"], indent=1))
    print(f"final corr: f32={out['float32']['final_corr']:.4f} "
          f"bf16={out['bfloat16']['final_corr']:.4f}")
    print(f"wrote {path}")


if __name__ == "__main__":
    main()

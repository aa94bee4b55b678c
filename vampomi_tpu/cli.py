"""Command-line interface, flag-compatible with the reference
(src/options.cpp:13-290 — exact spellings, including `--true-signal-file`,
`--pval-method`, `--alpha-scale`, `--learn-prior-delay`).

One unified driver covers both models (the reference's separate probit
binary, src/main_meth_probit.cpp, is stale — SURVEY Q2): select the probit
path with `--model bin_class`.  Run modes: infere | test | association_test |
predict.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from .config import RunConfig


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="vampomi_tpu",
        description="gVAMP for omics-scale Bayesian regression",
    )
    s = p.add_argument_group("files")
    s.add_argument("--meth-file", default="")
    s.add_argument("--meth-file-test", default="")
    s.add_argument("--phen-file", default="")
    s.add_argument("--phen-file-test", default="")
    s.add_argument("--true-signal-file", default="")
    s.add_argument("--estimate-file", default="")
    s.add_argument("--r1-file", default="")
    s.add_argument("--cov-estimate-file", default="",
                   help="accepted for flag parity; unused (the reference "
                        "parses but never consumes it, SURVEY Q-notes)")
    s.add_argument("--cov-file", default="")
    s.add_argument("--cov-file-test", default="")
    s.add_argument("--out-dir", default="")
    s.add_argument("--out-name", default="")

    m = p.add_argument_group("mode")
    m.add_argument("--run-mode", default="infere",
                   choices=["infere", "test", "association_test", "predict"])
    m.add_argument("--model", default="linear", choices=["linear", "bin_class"])
    # loo_std: calibrated LOO (standardized add-back) — ours, not in the
    # reference (see modes/association.py docstring)
    m.add_argument("--pval-method", default="se", choices=["se", "loo", "loo_std"])

    d = p.add_argument_group("dimensions")
    d.add_argument("--Mt", type=int, default=0)
    d.add_argument("--N", type=int, default=0)
    d.add_argument("--N-test", type=int, default=0)
    d.add_argument("--Mt-test", type=int, default=0)
    d.add_argument("--C", type=int, default=0)

    h = p.add_argument_group("hyperparameters")
    h.add_argument("--iterations", type=int, default=50)
    h.add_argument("--stop-criteria-thr", type=float, default=0.01)
    h.add_argument("--merge-vars-thr", type=float, default=5e-1)
    h.add_argument("--EM-err-thr", type=float, default=1e-2)
    h.add_argument("--EM-max-iter", type=int, default=1)
    h.add_argument("--CG-max-iter", type=int, default=500)
    h.add_argument("--CG-err-tol", type=float, default=1e-5)
    # default -1 = "not passed": the flag is decorative (prior size is
    # len(--probs), reference options.cpp:147-155 / SURVEY Q6) — warn only
    # when the user explicitly supplies a disagreeing value
    h.add_argument("--num-mix-comp", type=int, default=-1)
    h.add_argument("--learn-vars", type=int, default=1)
    h.add_argument("--learn-prior-delay", type=int, default=1)
    # beyond-reference: truth-free signal-budget EM stabilizer (0 = off;
    # 0.9 recommended at M/N >= 16 — see warn_em_stability / DESIGN.md 2b)
    h.add_argument("--em-h2-budget", type=float, default=0.0)
    h.add_argument("--alpha-scale", type=float, default=1.0)
    h.add_argument("--probit-var", type=float, default=1.0)
    h.add_argument("--rho", type=float, default=0.5)
    h.add_argument("--h2", type=float, default=0.5)
    h.add_argument("--gam1", type=float, default=1e-6)
    h.add_argument("--verbosity", type=int, default=0)
    h.add_argument("--redglob", type=int, default=0)
    h.add_argument("--vars", type=str, default="")
    h.add_argument("--probs", type=str, default="")
    h.add_argument("--test-iter-range", type=str, default="")

    x = p.add_argument_group("extensions (not in the reference)")
    x.add_argument("--compute-dtype", default="auto",
                   choices=["auto", "float64", "float32", "bfloat16", "int8",
                            "int4", "f64", "f32", "bf16", "i8", "i4"])
    x.add_argument("--seed", type=int, default=0)
    x.add_argument("--lmmse-solver", default="auto",
                   choices=["auto", "cg", "spectral", "eigen"],
                   help="LMMSE solve: CG (reference-parity), the exact "
                        "spectral/Woodbury path (ops/spectral.py), or the "
                        "eigen path (ops/eigen.py: once-per-dataset "
                        "diagonalization, O(N^2) per-iteration dense work)")
    x.add_argument("--spectral-max-n", type=int, default=16384,
                   help="auto solver picks spectral only when N <= this")
    x.add_argument("--eigen-cache", default="",
                   help="persist the once-per-dataset eigenbasis to this "
                        ".npz and reload it on later runs over the same "
                        "dataset (skips the build)")
    x.add_argument("--eigen-build-budget", type=float, default=0.0,
                   help="wall-clock seconds the eigen build may take "
                        "(0 = unlimited); on overrun the run falls back "
                        "to the per-iteration spectral factor")
    x.add_argument("--checkpoint-file", default="",
                   help="write an exact-state .npz after every iteration")
    x.add_argument("--resume-file", default="",
                   help="resume exactly from a checkpoint .npz")
    x.add_argument("--trace", type=int, default=1,
                   help="write <out>_trace.jsonl per-iteration telemetry")
    x.add_argument("--init-conf", default="",
                   help="Gibbs warm-start .conf (scripts/conf_gibbs_init.py): "
                        "loads rho/probs/vars/h2; explicit --probs/--vars "
                        "flags still win (the reference consumed the .conf "
                        "via shell glue, README.md:185-196)")
    x.add_argument("--profile-dir", default="",
                   help="capture a JAX/XLA profiler trace of the run into "
                        "this directory (view with TensorBoard/Perfetto)")
    return p


def load_init_conf(path: str) -> dict:
    """Parse a conf_gibbs_init .conf (tab-separated: ID rho mix_comp lambda
    probs vars h2; probs/vars comma-joined)."""
    lines = [l for l in open(path).read().splitlines() if l.strip()]
    header = lines[0].split("\t")
    fields = dict(zip(header, lines[1].split("\t")))
    return dict(
        rho=float(fields["rho"]),
        h2=float(fields["h2"]),
        probs=[float(v) for v in fields["probs"].split(",")],
        vars=[float(v) for v in fields["vars"].split(",")],
    )


def parse_config(argv: list[str]) -> RunConfig:
    args = build_parser().parse_args(argv)
    cfg = RunConfig()
    for f in vars(args):
        key = f  # argparse already converted dashes to underscores
        if key in ("vars", "probs", "test_iter_range", "init_conf",
                   "num_mix_comp"):
            continue
        setattr(cfg, key, getattr(args, f))
    if args.num_mix_comp >= 0:
        cfg.num_mix_comp = args.num_mix_comp
    if args.init_conf:
        conf = load_init_conf(args.init_conf)
        cfg.rho, cfg.h2 = conf["rho"], conf["h2"]
        cfg.probs, cfg.vars = conf["probs"], conf["vars"]
    if args.vars:
        cfg.vars = [float(v) for v in args.vars.split(",")]
    if args.probs:
        cfg.probs = [float(v) for v in args.probs.split(",")]
    if args.test_iter_range:
        cfg.test_iter_range = [int(v) for v in args.test_iter_range.split(",")]
    if args.num_mix_comp >= 0 and args.num_mix_comp != len(cfg.probs):
        print(f"WARNING: --num-mix-comp {args.num_mix_comp} is decorative — "
              f"the prior has len(--probs) = {len(cfg.probs)} components "
              f"(reference options.cpp:147-155, SURVEY Q6)")
    cfg.check()
    return cfg


def main(argv: list[str] | None = None) -> int:
    cfg = parse_config(sys.argv[1:] if argv is None else argv)

    import os

    import jax

    # Multi-process execution: the analog of the reference's `mpirun -np R`
    # (src/main_meth.cpp:12-18).  Launch one process per host (or per GPU)
    # with VAMPOMI_DISTRIBUTED=1.  On GPUs nothing discovers the cluster:
    # each process gets JAX_COORDINATOR_ADDRESS (host:port of process 0),
    # JAX_NUM_PROCESSES and JAX_PROCESS_ID from its environment.
    # NOTE: must run before anything touches the backend (jax.process_count
    # itself would initialize a 1-process backend and poison the guard)
    if os.environ.get("VAMPOMI_DISTRIBUTED") == "1":
        missing = [k for k in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
                               "JAX_PROCESS_ID") if not os.environ.get(k)]
        if missing:
            raise SystemExit("FATAL  : VAMPOMI_DISTRIBUTED=1 needs "
                             + ", ".join(missing) + " in the environment")
        jax.distributed.initialize(
            coordinator_address=os.environ["JAX_COORDINATOR_ADDRESS"],
            num_processes=int(os.environ["JAX_NUM_PROCESSES"]),
            process_id=int(os.environ["JAX_PROCESS_ID"]),
        )

    from .dataset import load_dataset
    from .io.bin_io import read_bin_slab
    from .sharding import make_mesh

    mesh = make_mesh()
    dtype = cfg.resolved_compute_dtype()

    import contextlib

    profile_ctx = (
        jax.profiler.trace(cfg.profile_dir)
        if cfg.profile_dir else contextlib.nullcontext()
    )

    if cfg.run_mode == "infere":
        ds = load_dataset(
            cfg.meth_file, cfg.phen_file, cfg.N, cfg.Mt, cfg.model, mesh, dtype,
            alpha_scale=cfg.alpha_scale, cov_file=cfg.cov_file, c=cfg.C,
        )
        true_signal = (
            read_bin_slab(cfg.true_signal_file, cfg.Mt)
            if cfg.true_signal_file else None
        )
        x1hat_init = (
            read_bin_slab(cfg.estimate_file, cfg.Mt) if cfg.estimate_file else None
        )
        if cfg.model == "bin_class":
            from .engine.probit import infere_bin_class

            with profile_ctx:
                infere_bin_class(ds.dm, ds.phen.y, cfg, true_signal, x1hat_init,
                                 covariates=ds.covariates)
        else:
            from .engine.linear import infere_linear

            with profile_ctx:
                infere_linear(ds.dm, ds.phen.y, cfg, true_signal, x1hat_init,
                          covariates=ds.covariates)

    elif cfg.run_mode == "test":
        ds = load_dataset(
            cfg.meth_file_test, cfg.phen_file_test, cfg.N_test, cfg.Mt,
            cfg.model, mesh, dtype, alpha_scale=cfg.alpha_scale,
        )
        if cfg.model == "bin_class":
            from .modes.test_mode import run_test_probit

            run_test_probit(ds, cfg)
        else:
            from .modes.test_mode import run_test_linear

            run_test_linear(ds, cfg)

    elif cfg.run_mode == "association_test":
        ds = load_dataset(
            cfg.meth_file, cfg.phen_file, cfg.N, cfg.Mt, cfg.model, mesh, dtype,
            alpha_scale=cfg.alpha_scale,
        )
        from .modes.association import run_association_test

        run_association_test(ds, cfg)

    elif cfg.run_mode == "predict":
        ds = load_dataset(
            cfg.meth_file_test, cfg.phen_file_test, cfg.N_test, cfg.Mt,
            cfg.model, mesh, dtype, alpha_scale=cfg.alpha_scale,
        )
        from .modes.predict import run_predict

        run_predict(ds, cfg)

    return 0


if __name__ == "__main__":
    raise SystemExit(main())

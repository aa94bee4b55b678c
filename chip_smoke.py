#!/usr/bin/env python3
"""Smoke test of the whole system on one GPU: `python chip_smoke.py`.

Drives the main path through the entry points a user calls, at the
reference's large-scale shape, and checks every result against the repo's
own references.  One process holds the card at a time.  Phases, in order:

  env        the card's name and power limit (nvidia-smi), JAX versions,
             devices, XLA_FLAGS and compile cache; fails without a GPU
  gpu-tests  the `gpu`-marked tests, in a child that finishes before this
             process first touches the card
  oracle     the CLI in-process (`vampomi_tpu.cli.main`) against the f64
             numpy oracle (tests/reference_impl.py) at N=1000 x M=2000,
             then the default f32 run, test, association (se, loo),
             bin_class infere and predict, with byte-format checks
  kernels    every operator route (int8, packed int4, f32 X; K=1 and K=2)
             against an exact f64 product at M=2^20 x N=10240, timings of
             the int8 reduce routes beside a copy, and the memory analysis
             of the int8 iteration phase
  scale      `infere_linear` (the engine behind the CLI and api.fit_*) on an
             int8 design at M=2^20 x N=10240 with the eigen solver and EM on,
             then default-dtype (f32) runs: at M=262144 x N=8192 from a
             generic prior with EM on, and at M=2^20 x N=10240 (a 43 GB X);
             eigen build beside jnp.linalg.eigh on the same Gram

`--four` runs only the four-GPU check: the int8 engine on a 4-device marker
mesh against the same problem on one of those devices, for two seeds.

Exits non-zero if any phase fails.  The last line of standard output is one
JSON object naming the device, printed only when every phase passed.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

REPO = os.path.dirname(os.path.abspath(__file__))
M_BIG, N_BIG = 1_048_576, 10_240
M_F32, N_F32 = 262_144, 8_192
PROBS3 = [0.9, 0.07, 0.03]
VARS3 = [0.0, 1e-3, 1e-2]

# CLI flags of the oracle run: tests/test_engine_linear.py base_cfg
ORACLE_FLAGS = [
    "--rho", "0.5", "--h2", "0.8", "--gam1", "1e-6",
    "--probs", ",".join(map(str, PROBS3)), "--vars", ",".join(map(str, VARS3)),
    "--CG-max-iter", "500", "--CG-err-tol", "1e-5", "--EM-max-iter", "1",
    "--EM-err-thr", "1e-2", "--learn-vars", "1", "--learn-prior-delay", "1",
    "--merge-vars-thr", "0.5", "--stop-criteria-thr", "1e-8", "--seed", "7",
    "--lmmse-solver", "cg",
]
# f32 against the f64 run of the same CLI, worst x1 iterate: f32 rounding
# (2.1e-6 in a CPU rehearsal) with room for another summation order; TF32
# operands would deviate ~1e-3
F32_VS_F64_TOL = 1e-4

# scale phase: sparse truth with CM = M/10^4 causal markers and h2 = 0.8
# (reference data_sim.py model, lam cut from the reference's 0.01 to keep
# CM/N ~ 0.01: at lam = 0.01 and M/N ~ 100 the truth has CM ~ N nonzeros and
# a CPU rehearsal at N=2048 ends at x1 corr 0.12), damping rho = 0.8.  At
# M/N ~ 100 and N >= 2048 the reference default rho = 0.5 peaks near
# iteration 2 and then diverges — on the CPU in f64, with the cg solver as
# with eigen, so it is the algorithm's, not the card's (PERF.md)
SCALE_LAM, SCALE_H2, SCALE_RHO, SCALE_ITERS = 1e-4, 0.8, 0.8, 5
# x1 correlation with the truth after the run; CPU rehearsals with the same
# M/N, CM/N, rho and EM settings reached 0.996 (int8, EM from the planted
# prior, M/N=104, N=2048, 5 iterations) and, from the generic PROBS3/VARS3
# prior at M/N=32, 0.990 at N=2048 after 5 iterations and 0.996 at N=4096
# after 8 — each doubling of N costs that EM about one more iteration, so the
# N=8192 run takes GENERIC_ITERS
SCALE_MIN_CORR = 0.9
GENERIC_ITERS = 10


class Card:
    """The card's name and power limit, carried by every printed time."""

    text = "no GPU"

    @classmethod
    def query(cls) -> str:
        try:
            out = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"],
                capture_output=True, text=True, timeout=60)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise RuntimeError(f"no GPU: nvidia-smi unavailable ({e})") from e
        if out.returncode != 0 or not out.stdout.strip():
            raise RuntimeError(f"no GPU: nvidia-smi failed: {out.stderr.strip()}")
        cls.text = " | ".join(line.strip() for line in out.stdout.splitlines()
                              if line.strip())
        return cls.text


def say(msg: str) -> None:
    print(msg, flush=True)


def result_line(platform: str, kind: str, count: int) -> str:
    """The contract's last line."""
    return json.dumps({"ok": True, "device": {
        "platform": platform, "kind": kind, "count": count}})


def rel_err(got, ref) -> float:
    """max |got - ref| / max |ref| (normwise, inf-norm); the absolute
    error where ref is all zero."""
    import numpy as np

    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    scale = np.max(np.abs(ref))
    return float(np.max(np.abs(got - ref)) / (scale if scale > 0 else 1.0))


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


# --------------------------------------------------------------------------
# byte formats (the reference's: tests/test_io.py)
# --------------------------------------------------------------------------


def check_positional_csv(path: str) -> list[list[float]]:
    """Header at offset 0; row k = "%5d" + (", %20.15f" per value) + "\\n" at
    byte offset k * len(row); NUL bytes in every gap; finite values
    (reference utilities.cpp:366-401, tests/test_io.py)."""
    import re

    import numpy as np

    raw = open(path, "rb").read()
    header_end = raw.index(b"\n") + 1
    row_re = re.compile(rb"[ \d]{4}\d(, [ \-\d]{3}\d*\.\d{15})+\n")
    rows, pos = [], header_end
    while pos < len(raw):
        if raw[pos] == 0:
            pos += 1
            continue
        end = raw.index(b"\n", pos) + 1
        line = raw[pos:end]
        check(row_re.fullmatch(line) is not None, f"{path}: bad row {line!r}")
        it = int(line[:5])
        check(pos == it * len(line), f"{path}: row {it} at offset {pos}, "
                                     f"expected {it * len(line)}")
        vals = [float(t) for t in line.decode().split(",")]
        check(bool(np.all(np.isfinite(vals))), f"{path}: non-finite row {it}")
        rows.append(vals)
        pos = end
    check(len(rows) > 0, f"{path}: no rows")
    return rows


def check_marker_bin(path: str, mt: int, lo=None, hi=None):
    """Marker-major little-endian f64, exactly 8*Mt bytes, finite."""
    import numpy as np

    check(os.path.getsize(path) == 8 * mt,
          f"{path}: {os.path.getsize(path)} bytes, expected {8 * mt}")
    v = np.fromfile(path, dtype="<f8")
    check(bool(np.all(np.isfinite(v))), f"{path}: non-finite values")
    if lo is not None:
        check(bool(np.all((v >= lo) & (v <= hi))), f"{path}: outside [{lo}, {hi}]")
    return v


# --------------------------------------------------------------------------
# oracle: CLI parity with the numpy f64 oracle
# --------------------------------------------------------------------------


def _cli(args: list[str], log) -> None:
    from vampomi_tpu.cli import main as cli_main

    with contextlib.redirect_stdout(log):
        rc = cli_main(args)
    check(rc in (0, None), f"cli returned {rc}: {args}")


def oracle_parity(workdir: str, n: int, m: int, iterations: int,
                  dtype: str, log, seed: int = 11) -> dict:
    """Run the CLI's linear infere at `dtype` on a data_sim fixture and lock
    its trajectory to NumpyVampOracle with tests/test_engine_linear.py's
    tolerances.  Returns the fixture paths and worst relative deviations."""
    import numpy as np

    from tests.reference_impl import NumpyVampOracle, engine_probes
    from vampomi_tpu.io.csv_writer import read_positional_csv
    from vampomi_tpu.io.phen import read_phen
    from vampomi_tpu.sim.data_sim import simulate_iid, write_fixture

    paths = write_fixture(simulate_iid(n, m, lam=0.1, h2=0.8, seed=seed),
                          workdir, "ex")
    name = f"o_{dtype}"
    _cli(["--run-mode", "infere", "--model", "linear",
          "--meth-file", paths["bin"], "--phen-file", paths["phen"],
          "--true-signal-file", paths["ts"], "--N", str(n), "--Mt", str(m),
          "--out-dir", workdir, "--out-name", name,
          "--iterations", str(iterations), "--compute-dtype", dtype]
         + ORACLE_FLAGS, log)

    X = np.fromfile(paths["bin"], dtype="<f8").reshape(m, n).T
    y = read_phen(paths["phen"], n).y
    oracle = NumpyVampOracle(
        X, y, PROBS3, VARS3, gam1=1e-6, h2=0.8, rho=0.5, cg_max_iter=500,
        cg_err_tol=1e-5, em_max_iter=1, em_err_thr=1e-2, learn_vars=1,
        learn_prior_delay=1, merge_vars_thr=0.5, stop_criteria_thr=1e-8)
    hist = oracle.run(iterations, engine_probes(7, iterations, m, m))

    base = os.path.join(workdir, name)
    params = check_positional_csv(base + "_params.csv")
    check(len(params) == len(hist), f"{len(params)} params rows, oracle "
                                    f"ran {len(hist)} iterations")
    # (column, oracle key, rtol) — tests/test_engine_linear.py
    cols = [(1, "alpha1", 1e-6), (2, "gam1_pre", 1e-6), (3, "alpha2", 1e-4),
            (4, "gam2", 1e-5), (5, "gamw", 1e-4)]
    worst = {}
    for row, h in zip(params, hist):
        check(int(row[0]) == h["it"], f"row {row[0]} vs oracle it {h['it']}")
        for c, key, rtol in cols:
            d = abs(row[c] - h[key]) / abs(h[key])
            worst[key] = max(worst.get(key, 0.0), d)
            check(d <= rtol, f"it {h['it']} {key}: {row[c]} vs oracle "
                             f"{h[key]} (rel {d:.2e} > {rtol})")
    x1s = []
    for h in hist:
        x1 = check_marker_bin(f"{base}_it_{h['it']}.bin", m)
        want = h["x1_hat"] / np.sqrt(n)
        np.testing.assert_allclose(x1, want, rtol=1e-4, atol=1e-12)
        worst["x1"] = max(worst.get("x1", 0.0), rel_err(x1, want))
        x1s.append(x1)
    r1_2 = check_marker_bin(f"{base}_r1_it_2.bin", m)
    np.testing.assert_allclose(r1_2, hist[0]["r1"] / np.sqrt(n),
                               rtol=1e-4, atol=1e-12)
    prior = read_positional_csv(base + "_prior.csv")[-1]
    k = int(prior[1])
    np.testing.assert_allclose(np.sort(prior[2:2 + k]),
                               np.sort(hist[-1]["probs"]), rtol=1e-5)
    np.testing.assert_allclose(np.sort(np.asarray(prior[2 + k:2 + 2 * k]) * n),
                               np.sort(hist[-1]["vars"]), rtol=1e-4)
    check_positional_csv(base + "_metrics.csv")
    return dict(paths=paths, name=name, worst=worst, x1=x1s, params=params)


def phase_oracle(workdir: str, log, n: int = 1000, m: int = 2000,
                 iterations: int = 4) -> None:
    import numpy as np

    f64 = oracle_parity(workdir, n, m, iterations, "float64", log)
    say("  f64 CLI vs NumpyVampOracle, worst relative deviation: "
        + ", ".join(f"{k} {v:.2e}" for k, v in f64["worst"].items())
        + "  (limits alpha1/gam1 1e-6, alpha2/gamw 1e-4, gam2 1e-5, x1 1e-4)")

    # the default dtype: f32 on the card (config.resolved_compute_dtype)
    base = os.path.join(workdir, "o_auto")
    paths = f64["paths"]
    _cli(["--run-mode", "infere", "--model", "linear",
          "--meth-file", paths["bin"], "--phen-file", paths["phen"],
          "--true-signal-file", paths["ts"], "--N", str(n), "--Mt", str(m),
          "--out-dir", workdir, "--out-name", "o_auto",
          "--iterations", str(iterations)] + ORACLE_FLAGS, log)
    dev = max(rel_err(check_marker_bin(f"{base}_it_{i + 1}.bin", m), x)
              for i, x in enumerate(f64["x1"]))
    say(f"  --compute-dtype auto (f32) vs f64 CLI run: worst x1 deviation "
        f"{dev:.2e} (limit {F32_VS_F64_TOL:.0e})")
    check(dev <= F32_VS_F64_TOL, f"f32 run deviates {dev:.2e} from f64")

    common = ["--N", str(n), "--Mt", str(m), "--out-dir", workdir]
    it = iterations
    _cli(["--run-mode", "test", "--model", "linear",
          "--meth-file-test", paths["bin"], "--phen-file-test", paths["phen"],
          "--N-test", str(n), "--Mt", str(m), "--out-dir", workdir,
          "--out-name", "o_auto", "--estimate-file", f"{base}_it_{it}.bin",
          "--test-iter-range", f"1,{it}"], log)
    rows = check_positional_csv(f"{base}_test.csv")
    say(f"  test mode: {len(rows)} rows, R2 at it {it} = {rows[-1][1]:.4f}")
    gam1 = check_positional_csv(f"{base}_params.csv")[-1][2]
    _cli(["--run-mode", "association_test", "--pval-method", "se",
          "--meth-file", paths["bin"], "--phen-file", paths["phen"],
          "--r1-file", f"{base}_r1_it_{it}.bin", "--gam1", repr(gam1),
          "--out-name", "o_auto"] + common, log)
    check_marker_bin(f"{base}_it_{it}_pval_se.bin", m, 0.0, 1.0)
    _cli(["--run-mode", "association_test", "--pval-method", "loo",
          "--meth-file", paths["bin"], "--phen-file", paths["phen"],
          "--estimate-file", f"{base}_it_{it}.bin",
          "--out-name", "o_auto"] + common, log)
    check_marker_bin(f"{base}_it_{it}_pval_loo.bin", m, 0.0, 1.0)
    say("  association se + loo: p-value files well-formed")

    y = np.loadtxt(paths["phen"], usecols=2)
    binp = os.path.join(workdir, "exb.phen")
    with open(binp, "w") as f:
        for i, v in enumerate(y):
            f.write(f"{i} {i} {int(v > 0)}\n")
    _cli(["--run-mode", "infere", "--model", "bin_class",
          "--meth-file", paths["bin"], "--phen-file", binp,
          "--out-name", "pb", "--iterations", "3", "--gam1", "1e-2",
          "--rho", "0.3", "--probs", "0.85,0.1,0.05",
          "--vars", "0.0,0.001,0.01"] + common, log)
    pb = os.path.join(workdir, "pb")
    check_marker_bin(f"{pb}_it_3.bin", m)
    check_positional_csv(f"{pb}_params.csv")
    _cli(["--run-mode", "predict", "--model", "bin_class",
          "--meth-file-test", paths["bin"], "--phen-file-test", binp,
          "--N-test", str(n), "--Mt", str(m), "--out-dir", workdir,
          "--out-name", "pb", "--estimate-file", f"{pb}_it_3.bin"], log)
    yhat = [f for f in os.listdir(workdir) if f.endswith(".yhat")]
    check(len(yhat) == 1, f"predict wrote {yhat}")
    v = np.loadtxt(os.path.join(workdir, yhat[0]), ndmin=2)
    check(v.shape[0] == n and bool(np.all(np.isfinite(v))),
          f"{yhat[0]}: shape {v.shape} or non-finite")
    say("  bin_class infere + predict: outputs finite and well-formed")


# --------------------------------------------------------------------------
# kernels: every operator route against an exact f64 product
# --------------------------------------------------------------------------

# (route, tolerance on max|err|/max|ref|, why)
TOLS = {
    "f32": (1e-4, "f32 rounding of sums over up to 2^20 terms; TF32 "
                  "operands would give ~3e-4"),
    "reduce": (5e-5, "exact codes x f32 y; only f32 accumulation rounds"),
    "bf16w": (5e-3, "the weight vector is rounded to bf16 (2^-9) before "
                    "the bf16 x bf16 -> f32 product"),
}


def _reference_products(dm, xs, ys, chunk: int = 16384):
    """(A xs, A^T ys) in f64, computed on the device over marker chunks
    (a whole f64 X would be 8 bytes per element)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    X = dm.X
    m = X.shape[0]
    n = int(dm.n)
    chunk = min(chunk, m)
    check(m % chunk == 0, f"M={m} not a multiple of {chunk}")

    @jax.jit
    def run(X, mave, msig, xs, ys):
        def body(i, carry):
            z, v = carry
            s = i * chunk
            Xc = jax.lax.dynamic_slice_in_dim(X, s, chunk, 0)
            if X.dtype == jnp.uint8:
                p = Xc.astype(jnp.int32)
                Xc = jnp.concatenate([(p & 15) - 8, (p >> 4) - 8], axis=1)
            mv = jax.lax.dynamic_slice_in_dim(mave, s, chunk, 0)
            ms = jax.lax.dynamic_slice_in_dim(msig, s, chunk, 0)
            Ac = (Xc.astype(jnp.float64) - mv[:, None]) * ms[:, None]
            xc = jax.lax.dynamic_slice_in_dim(xs, s, chunk, 0)
            z = z + Ac.T @ xc
            v = jax.lax.dynamic_update_slice_in_dim(v, Ac @ ys, s, 0)
            return z, v

        z0 = jnp.zeros((n, xs.shape[1]), jnp.float64)
        v0 = jnp.zeros((m, ys.shape[1]), jnp.float64)
        z, v = jax.lax.fori_loop(0, m // chunk, body, (z0, v0))
        return z / np.sqrt(n), v / np.sqrt(n)

    f64 = lambda a: jnp.asarray(a, jnp.float64)  # noqa: E731
    return run(X, f64(dm.mave), f64(dm.msig), f64(xs), f64(ys))


def check_routes(dm, seed: int, label: str) -> dict:
    """atx/ax (K=1) and atx_batch/ax_batch (K=2) of `dm` against the f64
    reference, each jitted as the engine jits them (jit_for_design) and
    timed; prints and returns each error, raises past its tolerance."""
    import jax
    import jax.numpy as jnp

    from vampomi_tpu.ops.operator import (
        atx, atx_batch, ax, ax_batch, design_compile_options, jit_for_design,
    )

    m, n = dm.m_pad, int(dm.n)
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    xs = jax.random.normal(k1, (m, 2), jnp.float32)
    ys = jax.random.normal(k2, (n, 2), jnp.float32)
    z_ref, v_ref = _reference_products(dm, xs, ys)
    x0, y0 = xs[:, 0] + 0, ys[:, 0] + 0  # contiguous single vectors
    quant = dm.X.dtype in (jnp.int8, jnp.uint8)
    say(f"  {label}: X {dm.X.nbytes / 2**30:.1f} GiB, the package's compile "
        f"options for it: {design_compile_options(dm.X)}")
    kinds = {"ax": "bf16w" if quant else "f32",
             "atx": "reduce" if quant else "f32"}
    routes = {
        "ax": (ax, x0, z_ref[:, 0], kinds["ax"]),
        "ax_batch": (ax_batch, xs, z_ref, kinds["ax"]),
        "atx": (atx, y0, v_ref[:, 0], kinds["atx"]),
        "atx_batch": (atx_batch, ys, v_ref, kinds["atx"]),
    }
    found = {}
    for name, (fn, arg, ref, kind) in routes.items():
        tol, why = TOLS[kind]
        comp = jit_for_design(fn, dm)
        e = rel_err(comp(dm, arg), ref)
        t = _time(comp, dm, arg)
        found[name] = dict(err=e, ms=t * 1e3, gbps=dm.X.nbytes / t / 1e9)
        say(f"  {label:5s} {name:9s} max rel err {e:.2e} (tol {tol:.0e}: {why}); "
            f"{t * 1e3:.3f} ms, {dm.X.nbytes / t / 1e9:.0f} GB/s of X  [{Card.text}]")
        check(e <= tol, f"{label} {name}: {e:.2e} > {tol:.0e}")
    return found


def _time(fn, *args, reps: int = 10) -> float:
    """Median wall seconds of fn(*args) to block_until_ready, after a
    warm-up call that compiles."""
    import jax
    import numpy as np

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t)
    return float(np.median(ts))


def time_routes(dm) -> dict:
    """Both directions over int8 X by the operator's routes and by their
    alternatives, beside a copy of X.  Rates are bytes of X read per
    second; the copy's counts its read and its write."""
    import jax
    import jax.numpy as jnp

    from vampomi_tpu.ops.operator import reduce_rows

    X = dm.X
    m, n = X.shape
    nbytes = X.size * X.dtype.itemsize
    y = jax.random.normal(jax.random.PRNGKey(3), (n, 2), jnp.float32)
    w = jax.random.normal(jax.random.PRNGKey(4), (m, 2), jnp.float32)
    y0 = y[:, 0] + 0
    hp, bf = jax.lax.Precision.HIGHEST, jnp.bfloat16
    f32 = jnp.float32

    def colsum(X, w):
        # broadcast direction as one multi-output column reduction
        terms = tuple(X.astype(f32) * w[:, j:j + 1] for j in range(2))
        zero = jnp.zeros((), f32)
        return jnp.stack(jax.lax.reduce(
            terms, (zero, zero), lambda a, b: (a[0] + b[0], a[1] + b[1]),
            (0,)), axis=1)

    routes = {
        "copy": (lambda X: X + jnp.ones((), X.dtype), (X,), 2),
        "reduce K=1: (a) plain fused [operator]": (
            lambda X, y: reduce_rows(X, y[:, None]), (X, y0), 1),
        "reduce K=1: (b) bf16 einsum": (lambda X, y: jnp.einsum(
            "mn,n->m", X.astype(bf), y.astype(bf),
            preferred_element_type=f32, precision=hp), (X, y0), 1),
        "reduce K=2: plain fused [operator]": (reduce_rows, (X, y), 1),
        "reduce K=2: bf16 einsum": (lambda X, y: jnp.einsum(
            "mn,nk->mk", X.astype(bf), y.astype(bf),
            preferred_element_type=f32, precision=hp), (X, y), 1),
        "broadcast K=2: bf16 einsum [operator]": (lambda X, w: jnp.einsum(
            "mk,mn->nk", w.astype(bf), X.astype(bf),
            preferred_element_type=f32, precision=hp), (X, w), 1),
        "broadcast K=2: fused column sums": (colsum, (X, w), 1),
    }
    out = {}
    for name, (fn, args, passes) in routes.items():
        t = _time(jax.jit(fn), *args)
        out[name] = dict(ms=t * 1e3, gbps=passes * nbytes / t / 1e9)
        say(f"  int8 {name:40s} {t * 1e3:8.3f} ms {out[name]['gbps']:7.1f} GB/s"
            f"  [{Card.text}]")
    return out


def iteration_memory(dm) -> dict:
    """compiled.memory_analysis() of the engine's eigen iteration phase
    (engine/linear.py) for this design, lowered with stand-ins for the
    vectors and the eigenbasis."""
    import jax
    import jax.numpy as jnp

    from vampomi_tpu.engine.linear import _iteration_phase_eigen
    from vampomi_tpu.ops.eigen import EigenFactor
    from vampomi_tpu.prior.mixture import init_prior

    m, n = dm.m_pad, int(dm.n)
    sds = jax.ShapeDtypeStruct
    mv, yv = sds((m,), dm.wd), sds((n,), dm.wd)
    f64 = lambda v: jnp.asarray(v, jnp.float64)  # noqa: E731
    ef = EigenFactor(U=sds((n, n), dm.wd), lam=sds((n,), jnp.float64))
    comp = _iteration_phase_eigen.lower(
        dm, ef, mv, yv, mv, f64(1.0), init_prior(PROBS3, VARS3, n), mv,
        jnp.asarray(True), f64(0.5), f64(2.0), mv).compile()
    ma = comp.memory_analysis()
    fields = {k: int(getattr(ma, k)) for k in (
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "alias_size_in_bytes",
        "generated_code_size_in_bytes") if hasattr(ma, k)}
    return fields


def phase_kernels(m: int, n: int, seed: int) -> dict:
    import jax.numpy as jnp

    from vampomi_tpu.sim.device_sim import design_from_x, generate_x

    found = {}
    for label, dtype in (("int8", jnp.int8), ("int4", jnp.uint8),
                         ("f32", jnp.float32)):
        t0 = time.time()
        dm = design_from_x(generate_x(seed, m, n, dtype), n)
        say(f"  {label} X generated on the device: {dm.X.shape} {dm.X.dtype} "
            f"in {time.time() - t0:.1f}s  [{Card.text}]")
        found[label] = check_routes(dm, seed + 1, label)
        if label == "int8":
            found["timings"] = time_routes(dm)
            mem = iteration_memory(dm)
            found["memory"] = mem
            temp = mem.get("temp_size_in_bytes", 0)
            say(f"  int8 eigen iteration phase memory_analysis: "
                + ", ".join(f"{k}={v}" for k, v in mem.items()))
            say(f"  temp / (M*N) = {temp / (m * n):.3f}  (near 2 = a bf16 "
                f"copy of X per pass; near 0 = the int8->bf16 cast fused)")
        del dm
    return found


# --------------------------------------------------------------------------
# scale: the engine at the reference's large-scale shape
# --------------------------------------------------------------------------


def _scale_cfg(out_dir: str, **kw):
    from vampomi_tpu.config import RunConfig

    cm = max(1, round(M_BIG * SCALE_LAM))
    d = dict(out_dir=out_dir, out_name="scale", meth_file="<device>",
             iterations=SCALE_ITERS, h2=SCALE_H2, rho=SCALE_RHO, seed=7,
             probs=[1.0 - SCALE_LAM, SCALE_LAM], vars=[0.0, SCALE_H2 / cm],
             learn_vars=1, learn_prior_delay=1, stop_criteria_thr=0.0,
             lmmse_solver="eigen")
    d.update(kw)
    return RunConfig(**d)


def engine_run(m: int, n: int, dtype, cfg, seed: int, log, mesh=None,
               write_outputs: bool = True, lam: float = SCALE_LAM):
    """Generate X on the device, plant a sparse truth, run infere_linear.
    Returns (result, beta, corr with truth, dm)."""
    import numpy as np

    from vampomi_tpu.engine.linear import infere_linear
    from vampomi_tpu.sim.device_sim import (
        design_from_x, generate_x, plant_phenotype)

    t0 = time.time()
    dm = design_from_x(generate_x(seed, m, n, dtype, mesh=mesh), n)
    beta, y = plant_phenotype(dm, seed + 1, lam, SCALE_H2)
    gen_s = time.time() - t0
    with contextlib.redirect_stdout(log):
        res = infere_linear(dm, y, cfg, true_signal=beta,
                            write_outputs=write_outputs)
    check(bool(np.all(np.isfinite(res.x1_hat_scaled))), "non-finite x1_hat")
    check(np.isfinite(res.gam1) and np.isfinite(res.gamw), "non-finite gammas")
    corr = float(np.corrcoef(res.x1_hat_scaled, beta)[0, 1])
    return res, beta, corr, dm, gen_s


def _report_engine(label, res, corr, gen_s):
    setup = ", ".join(f"{k} {v:.3g}" for k, v in (res.setup or {}).items())
    its = ", ".join(f"{t:.4f}" for t in res.iter_seconds)
    say(f"  {label}: generation {gen_s:.1f}s; set-up: {setup}")
    say(f"  {label}: per-iteration wall s [{its}]  x1 corr with truth "
        f"{corr:.4f}  [{Card.text}]")


def eigh_beside_eigen(dm) -> dict:
    """jnp.linalg.eigh (cuSOLVER on the GPU) on the same Gram the engine
    diagonalized: wall time (compile included and excluded) and Rayleigh
    residual ||K U - U lam||_F / ||K||_F."""
    import jax
    import jax.numpy as jnp

    from vampomi_tpu.ops.spectral import build_spectral

    K = build_spectral(dm).K
    jax.block_until_ready(K)
    f = jax.jit(jnp.linalg.eigh)
    t = time.time()
    lam, U = jax.block_until_ready(f(K))
    cold = time.time() - t
    t = time.time()
    lam, U = jax.block_until_ready(f(K))
    warm = time.time() - t
    resid = float(jnp.linalg.norm(K @ U - U * lam[None, :])
                  / jnp.linalg.norm(K))
    return dict(cold_s=cold, warm_s=warm, resid=resid)


def phase_scale(workdir: str, seed: int, log) -> dict:
    import jax.numpy as jnp

    cfg = _scale_cfg(workdir)
    res, beta, corr, dm, gen_s = engine_run(M_BIG, N_BIG, jnp.int8, cfg,
                                           seed, log)
    _report_engine(f"int8 eigen M={M_BIG} N={N_BIG}", res, corr, gen_s)
    check(res.iterations_run == SCALE_ITERS, f"ran {res.iterations_run} its")
    check(corr >= SCALE_MIN_CORR, f"x1 corr {corr:.4f} < {SCALE_MIN_CORR}")
    # the params CSV is not checked here: gam2 reaches 1e4, where "%20.15f"
    # overflows its width and the reference's positional rows overlap
    check_positional_csv(os.path.join(workdir, "scale_metrics.csv"))
    check_marker_bin(os.path.join(workdir, f"scale_it_{SCALE_ITERS}.bin"), M_BIG)
    eig = eigh_beside_eigen(dm)
    say(f"  jnp.linalg.eigh on the same K (N={N_BIG}): cold {eig['cold_s']:.2f}s "
        f"warm {eig['warm_s']:.2f}s resid {eig['resid']:.2e}; ops/eigen.py "
        f"build {res.setup.get('eigen_s', float('nan')):.2f}s resid "
        f"{res.setup.get('eigen_resid', float('nan')):.2e}  [{Card.text}]")
    del dm

    from vampomi_tpu.config import RunConfig

    dtype = RunConfig(compute_dtype="auto").resolved_compute_dtype()
    check(dtype == jnp.float32, f"auto dtype on the card is {dtype}")
    found = dict(int8=dict(setup=res.setup, iters=res.iter_seconds, corr=corr),
                 eigh=eig)
    # the default dtype and solver: EM from the reference's generic
    # 3-component prior, then the same at the large-scale shape (43 GB of
    # f32 X, which the package compiles with autotuning off)
    runs = {
        "f32": (M_F32, N_F32, seed + 10, dict(
            out_name="scale_f32", iterations=GENERIC_ITERS, probs=PROBS3,
            vars=VARS3)),
        "f32_big": (M_BIG, N_BIG, seed + 20, dict(
            out_name="scale_f32_big", iterations=3,
            vars=[0.0, SCALE_H2 / max(1, round(M_BIG * SCALE_LAM))])),
    }
    for key, (m, n, s, kw) in runs.items():
        cfg32 = _scale_cfg(workdir, lmmse_solver="auto", **kw)
        res32, _, corr32, dm32, gen32 = engine_run(m, n, dtype, cfg32, s, log)
        _report_engine(f"f32 auto M={m} N={n}", res32, corr32, gen32)
        check(bool(res32.setup), f"auto solver built no Gram at M={m}")
        check(corr32 >= SCALE_MIN_CORR,
              f"f32 M={m}: x1 corr {corr32:.4f} < {SCALE_MIN_CORR}")
        found[key] = dict(setup=res32.setup, iters=res32.iter_seconds,
                          corr=corr32)
        del dm32
    return found


# --------------------------------------------------------------------------
# four cards
# --------------------------------------------------------------------------


# 4-vs-1-device limits on (iteration-2 x1, final x1, final gammas), each ~3x
# the largest difference of two earlier H100 runs at seed 0 (4.95e-5,
# 1.65e-3, 5.49e-4; PERF.md), where the first limits of 1e-3 on the final
# state had failed.  Iteration 2 is the first nonzero x1, one solve and one
# denoise from the start, so only f32 summation order separates the runs;
# the gamma recursion then amplifies that difference each iteration.
FOUR_TOLS = (1.5e-4, 5e-3, 2e-3)


def phase_four(workdir: str, seeds, log, m: int = M_BIG, n: int = N_BIG,
               solver: str = "eigen") -> dict:
    import jax
    import jax.numpy as jnp

    from vampomi_tpu.sharding import make_mesh

    devs = jax.devices()
    check(len(devs) == 4, f"--four needs 4 devices, JAX sees {len(devs)}")
    found = {}
    for seed in seeds:
        runs = {}
        for label, mesh in (("4 devices", make_mesh(devs)),
                            ("1 device", make_mesh(devs[:1]))):
            name = f"four_{label.split()[0]}_s{seed}"
            # EM off: only reduction order may separate the two runs' states
            cfg = _scale_cfg(workdir, out_name=name, lmmse_solver=solver,
                             vars=[0.0, SCALE_H2 / max(1, round(m * SCALE_LAM))],
                             learn_vars=0, learn_prior_delay=SCALE_ITERS)
            res, beta, corr, dm, gen_s = engine_run(
                m, n, jnp.int8, cfg, seed, log, mesh=mesh)
            if label == "4 devices":
                shards = {s.device.id: s.data.shape
                          for s in dm.X.addressable_shards}
                say(f"  X sharding {dm.X.sharding.spec}: per-device shards "
                    f"{shards}")
                used = {d.id: (d.memory_stats() or {}).get("bytes_in_use", -1)
                        for d in devs}
                say(f"  bytes in use per device after the run: {used}")
                check(len(shards) == 4 and all(
                    s == (m // 4, n) for s in shards.values()),
                    "X not split in 4")
            _report_engine(f"seed {seed}, {label} M={m} N={n}", res, corr,
                           gen_s)
            x1s = [check_marker_bin(
                os.path.join(workdir, f"{name}_it_{k}.bin"), m)
                for k in range(1, res.iterations_run + 1)]
            runs[label] = (res, x1s)
            del dm
        (a, xa), (b, xb) = runs["4 devices"], runs["1 device"]
        dx = [rel_err(u, v) for u, v in zip(xa, xb)]
        dg = max(abs(a.gam1 - b.gam1) / abs(b.gam1),
                 abs(a.gamw - b.gamw) / abs(b.gamw))
        say(f"  seed {seed}: 4 vs 1 device, x1 max rel diff per iteration: "
            + ", ".join(f"{d:.2e}" for d in dx) + f"; final gammas {dg:.2e}")
        found[seed] = dict(x1=dx, gammas=dg,
                           iters={k: v[0].iter_seconds for k, v in runs.items()})
    t2, tx, tg = FOUR_TOLS
    say(f"  limits: iteration-2 x1 {t2:.1e}, final x1 {tx:.0e}, final gammas "
        f"{tg:.0e} (f32 summation order, amplified by "
        f"{SCALE_ITERS - 2} more nonlinear iterations)")
    for seed, f in found.items():
        check(f["x1"][1] <= t2,
              f"seed {seed}: iteration-2 x1 differs by {f['x1'][1]:.2e}")
        check(f["x1"][-1] <= tx and f["gammas"] <= tg,
              f"seed {seed}: final state differs past its limits")
    return found


# --------------------------------------------------------------------------
# main
# --------------------------------------------------------------------------


def gpu_tests() -> None:
    """The `gpu`-marked tests in a child process that ends before this one
    touches the card."""
    env = dict(os.environ, VAMPOMI_TEST_GPU="1")
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "tests", "-m", "gpu", "-q", "-rs",
         "-p", "no:cacheprovider", "-p", "no:randomly"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=900)
    lines = out.stdout.strip().splitlines() or ["(no output)"]
    for line in lines:
        if line.startswith("SKIPPED") or line == lines[-1]:
            say(f"  pytest -m gpu: {line}")
    if (out.returncode != 0 or "passed" not in lines[-1]
            or "needs a GPU" in out.stdout):
        sys.stderr.write(out.stdout[-6000:] + out.stderr[-3000:])
        raise AssertionError(f"gpu tests: rc {out.returncode}, {lines[-1]}")


def env_phase() -> tuple[str, str, int]:
    import jax
    import jaxlib

    from vampomi_tpu._cachedir import cache_dir

    devs = jax.devices()
    say(f"  jax {jax.__version__} jaxlib {jaxlib.__version__}; devices {devs}")
    limit = (devs[0].memory_stats() or {}).get("bytes_limit", 0)
    say(f"  device_kind {devs[0].device_kind}; XLA_FLAGS="
        f"{os.environ.get('XLA_FLAGS', '')!r}; compile cache {cache_dir()}; "
        f"device memory JAX may use {limit / 2**30:.1f} GiB")
    if devs[0].platform != "gpu":
        raise RuntimeError(f"no GPU: JAX's first device is {devs[0].platform}")
    return devs[0].platform, devs[0].device_kind, len(devs)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU mesh check")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases", default="gpu-tests,oracle,kernels,scale",
                    help="comma-separated subset of the one-card phases")
    ap.add_argument("--log", default="",
                    help="file for the engine's per-iteration narration "
                         "(default: a temp file, shown on failure)")
    args = ap.parse_args(argv)

    t_start = time.time()
    try:
        say(f"card: {Card.query()}")
    except RuntimeError as e:
        say(f"FAILED env: {e}")
        return 1
    failed = []
    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    log_path = args.log or os.path.join(workdir, "engine.log")
    log = open(log_path, "w")

    def run(name, fn):
        t = time.time()
        say(f"[{name}]")
        try:
            fn()
            status = "ok"
        except Exception:
            traceback.print_exc()
            failed.append(name)
            status = "FAILED"
        say(f"[{name}] {status} in {time.time() - t:.1f}s  [{Card.text}]")
        return status == "ok"

    phases = set(args.phases.split(","))
    if not args.four and "gpu-tests" in phases:
        run("gpu-tests", gpu_tests)
    device = {}
    if run("env", lambda: device.setdefault("d", env_phase())):
        if args.four:
            run("four", lambda: phase_four(
                workdir, (args.seed, args.seed + 1), log))
        else:
            oracle_dir = os.path.join(workdir, "oracle")
            os.makedirs(oracle_dir)
            if "oracle" in phases:
                run("oracle", lambda: phase_oracle(oracle_dir, log))
            if "kernels" in phases:
                run("kernels", lambda: phase_kernels(M_BIG, N_BIG, args.seed))
            if "scale" in phases:
                run("scale", lambda: phase_scale(workdir, args.seed, log))
    log.close()
    say(f"total {time.time() - t_start:.1f}s  [{Card.text}]")
    if failed or "d" not in device:
        say(f"FAILED phases: {failed}; engine narration in {log_path}")
        with open(log_path) as f:
            sys.stderr.write("".join(f.readlines()[-40:]))
        return 1
    print(result_line(*device["d"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Benchmark: full VAMP iteration rate on the local accelerator.

Not yet a benchmark of record: it prints no device name and its shape
follows the card's memory.  No number it has printed on the H100 is kept
(PERF.md).

Measures the framework's production path — one complete linear-gVAMP
iteration (mixture denoiser + EM-ready reductions + exact LMMSE solve +
exact Onsager/noise traces + metrics) — at the LITERAL north-star workload
shape (BASELINE.json: "VAMP iterations/s at N~1e4, M~1e6"):

    M >= 1e6 markers x N = 10240 samples on one device, int8 design matrix
    (per-marker affine quantization, ops/operator.py quantize_markers —
    1 byte/element: 10.7 GB at M = 2^20, where f32 would need 43 GB).

vs_baseline = (time of the reference-structured algorithm on the SAME
chip) / (our time).  The reference algorithm is Jacobi-preconditioned CG
at the reference's defaults (CG_max_iter=500, src/options.hpp:83-84) with
warm start plus the Hutchinson Onsager/trace probe — implemented as our
`_iteration_phase` (ops/operator.py matvecs).  The narrow-int8 operands floor the CG
residual near 1e-3, so the baseline stops at tol 1e-3 (earlier than the
reference's 1e-5 asks — vs_baseline is conservative).  The reference
itself publishes no numbers (BASELINE.md).

Prints ONE json line:
  {"metric", "value", "unit", "vs_baseline", "matvec_gbps", "dense_ms"}
matvec_gbps is the BASELINE.json "LMMSE matvec GB/s/chip" north star
(bytes of X read per wall second during one A^T A v);  dense_ms is the
per-iteration dense (non-X) cost — the term that caps multi-chip scaling
(SCALING.md).

COLD-START CONTRACT: this bench must print its JSON line from a fully
cold machine — empty compilation cache, no eigen factor cache, and a
device that may hang mid-run.  Architecture:

  * a jax-free SUPERVISOR process re-execs this file as a measuring
    CHILD and watches a heartbeat state file; a child that hangs inside
    a stage past that stage's declared budget is killed and retried (the
    persistent compilation cache and the eigen factor cache make a retry
    cheap).  The supervisor never imports jax, so the child is the only
    process on the card;
  * the child measures in ESSENTIALS-FIRST order: matvec -> Gram build
    -> spectral-LMMSE iteration -> reference-CG baseline.  The moment
    those finish, a complete result line is in the state file — the
    eigen-LMMSE upgrade and the f32 cross-round companion run only under
    the remaining wall budget (the eigen build takes a hard deadline and
    aborts cleanly, ops/eigen.py EigenBuildTimeout);
  * the supervisor prints the best recorded result at exit — so a
    failure during the OPTIONAL stages still yields the essentials line.

Env knobs: VAMPOMI_BENCH_BUDGET (total wall seconds, default 1260),
VAMPOMI_BENCH_DTYPE=float32|bfloat16|int8|int4 (headline configuration),
VAMPOMI_BENCH_EIGEN_EST (cold eigen-build estimate gating the upgrade),
VAMPOMI_BENCH_SHAPE=M,N (smoke-test shape), VAMPOMI_BENCH_NO_SUPERVISE=1
(single-process debug mode), VAMPOMI_BENCH_NO_COMPANION=1.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

T0 = time.time()
BUDGET = float(os.environ.get("VAMPOMI_BENCH_BUDGET", "1260"))
STATE_ENV = "VAMPOMI_BENCH_STATE"
DEADLINE_ENV = "VAMPOMI_BENCH_CHILD_DEADLINE"

# set by _child_imports(); module-level so the helpers below can use them
jax = jnp = np = None


def log(msg):
    print(msg, file=sys.stderr, flush=True)


# --------------------------------------------------------------------------
# state file: the supervisor/child contract (atomic JSON writes)
# --------------------------------------------------------------------------


def _write_state(path, st):
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(st, f)
    os.replace(tmp, path)


def _read_state(path):
    try:
        with open(path) as f:
            return json.load(f)
    except Exception:
        return None


class StageTracker:
    """Child-side progress record the supervisor watches for liveness."""

    def __init__(self, path):
        self.path = path
        self.st = {"stage": "boot", "stage_start": time.time(),
                   "stage_max": 120, "result": None, "done": False}
        if path:
            _write_state(path, self.st)

    def stage(self, name, max_s):
        # test hook: cap budgets / hang deterministically so the suite can
        # drive the supervisor's kill-and-retry path (a child hung mid-stage)
        # in seconds.  Inert unless the env vars are set.
        cap = os.environ.get("VAMPOMI_BENCH_TEST_STAGE_MAX")
        if cap:
            max_s = min(max_s, float(cap))
        log(f"[stage] {name} (budget {max_s:.0f}s, "
            f"t+{time.time() - T0:.0f}s)")
        self.st.update(stage=name, stage_start=time.time(), stage_max=max_s)
        if self.path:
            _write_state(self.path, self.st)
        if name == os.environ.get("VAMPOMI_BENCH_TEST_HANG_STAGE"):
            marker = os.environ.get("VAMPOMI_BENCH_TEST_HANG_ONCE")
            if not (marker and os.path.exists(marker)):
                if marker:
                    open(marker, "w").close()
                log(f"[test-hook] hanging in {name}")
                while True:
                    time.sleep(1)

    def record(self, result):
        self.st["result"] = result
        if self.path:
            _write_state(self.path, self.st)

    def finish(self):
        self.st["done"] = True
        if self.path:
            _write_state(self.path, self.st)


# --------------------------------------------------------------------------
# measurement helpers (child only — jax is imported by _child_imports)
# --------------------------------------------------------------------------


def _child_imports():
    global jax, jnp, np
    import jax as _jax

    if os.environ.get("JAX_PLATFORMS", "").strip() == "cpu":
        # jax may already be imported with another platform selected; the
        # env var alone does not undo that
        _jax.config.update("jax_platforms", "cpu")
        if "--xla_cpu_max_isa" not in os.environ.get("XLA_FLAGS", ""):
            # keep XLA:CPU persistent-cache entries loadable (the AVX512
            # prefer-no-gather/scatter pseudo-features fail the AOT
            # loader's machine check on jax 0.9.0 — tests/conftest.py)
            os.environ["XLA_FLAGS"] = (
                os.environ.get("XLA_FLAGS", "") + " --xla_cpu_max_isa=AVX2"
            )
    import jax.numpy as _jnp
    import numpy as _np

    jax, jnp, np = _jax, _jnp, _np


def pick_shape(dtype):
    """Largest M (multiple of 16384 — make_problem's RNG chunk) such that X
    plus the dense state (K, U, and the eigen build's ~5 N^2 f32
    transients) fits the device's memory, capped near the north-star
    M ~ 1e6.  A device that does not report its memory limit is an error:
    no size is assumed for it."""
    stats = jax.devices()[0].memory_stats() or {}
    if "bytes_limit" not in stats:
        raise RuntimeError(
            f"{jax.devices()[0].device_kind}: memory_stats() reports no "
            f"bytes_limit; set VAMPOMI_BENCH_SHAPE=M,N")
    limit = stats["bytes_limit"]
    itemsize = jnp.dtype(dtype).itemsize
    if dtype == jnp.uint8:  # packed int4: two codes per byte
        n = 10240
        budget = int(limit) - int(6.4e9)
        m = max(budget // (n // 2), 16384) // 16384 * 16384
        # 2x the int8 marker capacity at the same byte budget
        return int(min(m, 2_097_152)), n
    if dtype == jnp.int8:
        n = 10240
        # K + U + the eigen build's sign/subspace transients peak at
        # ~2.2 GB at N=10240; budget 6.4 GB of non-X overhead
        budget = int(limit) - int(6.4e9)
    else:
        n = 8192
        budget = int(limit * 0.77) - 7 * n * n * 4
    m = max(budget // (n * itemsize), 16384) // 16384 * 16384
    return int(min(m, 1_310_720)), n


def gen_x(m, n, dtype):
    """Deterministic synthetic X — callable twice to REGENERATE the matrix
    bit-identically after it was freed to make room for the eigen build
    (cheaper than holding 10+ GB through a dense build or a host
    round trip).

    Chunked under lax.scan so the RNG's internal full-precision transient
    never exceeds one chunk (a single jax.random call at (m, n) would
    spike ~4x the int8 X footprint)."""
    chunk = 16384
    assert m % chunk == 0 or m < chunk
    kx = jax.random.split(jax.random.PRNGKey(0), 3)[0]

    def gen_chunk(kk):
        if dtype == jnp.uint8:
            # packed int4: uniform random bytes = two independent uniform
            # nibbles per byte (codes uniform over [-8, 7] after unbias)
            return jax.random.randint(
                kk, (chunk, n // 2), 0, 256, dtype=jnp.uint8
            )
        if dtype == jnp.int8:
            # synthetic already-quantized codes (uniform over the affine
            # range); msig folds the 1/sd like quantize_markers does
            return jax.random.randint(kk, (chunk, n), -127, 128, dtype=jnp.int8)
        return jax.random.normal(kk, (chunk, n), dtype=dtype)

    cols = n // 2 if dtype == jnp.uint8 else n
    if m <= chunk:
        return gen_chunk(kx)[:m]

    @jax.jit
    def gen(k):
        ks = jax.random.split(k, m // chunk)
        _, out = jax.lax.scan(lambda c, kk: (c, gen_chunk(kk)), 0, ks)
        return out.reshape(m, cols)

    return gen(kx)


def make_problem(m, n, dtype):
    from vampomi_tpu.ops.operator import DesignMatrix
    from vampomi_tpu.prior.mixture import init_prior

    wd = jnp.float32 if dtype in (jnp.bfloat16, jnp.int8, jnp.uint8) else dtype
    key = jax.random.PRNGKey(0)
    _, ky, kr = jax.random.split(key, 3)

    X = gen_x(m, n, dtype)
    # per-marker inverse sd of the uniform synthetic codes:
    # int8 range 255, int4 range 15 -> sd = range/sqrt(12)
    sig = {jnp.dtype(jnp.int8): np.sqrt(12.0) / 255.0,
           jnp.dtype(jnp.uint8): np.sqrt(12.0) / 15.0}.get(jnp.dtype(dtype), 1.0)
    dm = DesignMatrix(
        X=X,
        mave=jnp.zeros(m, dtype=wd),
        msig=jnp.full((m,), sig, dtype=wd),
        mmask=jnp.ones(m, dtype=wd),
        inv_sqrt_n=jnp.asarray(1.0 / np.sqrt(float(n)), dtype=wd),
        n=jnp.asarray(float(n), dtype=jnp.float64),
        mt=jnp.asarray(float(m), dtype=jnp.float64),
    )
    y = jax.random.normal(ky, (n,), dtype=wd)
    # mid-trajectory-like state: r1 = sparse-ish signal + noise, moderate gammas
    r1 = 0.3 * jax.random.normal(kr, (m,), dtype=wd)
    prior = init_prior([0.9, 0.07, 0.03], [0.0, 1e-3, 1e-2], n)
    return dm, y, r1, prior


def sync(x):
    # fence: fetch ONE element (ravel would materialize a full copy inside
    # the timed window)
    return float(jax.device_get(x[(0,) * x.ndim]))


def time_calls(fn, k=5):
    sync(fn())  # warm/compile
    t0 = time.perf_counter()
    for _ in range(k):
        out = fn()
    sync(out)
    return (time.perf_counter() - t0) / k


def _itemsize(dtype):
    return 0.5 if dtype == jnp.uint8 else jnp.dtype(dtype).itemsize


def _dtype_name(dtype):
    return "int4(packed)" if dtype == jnp.uint8 else jnp.dtype(dtype).name


def run_config(m, n, dtype, tracker, deadline, headline=True):
    """Measure one configuration, ESSENTIALS FIRST.  Returns the result
    dict; when `headline`, intermediate results are recorded in the
    tracker the moment they become valid so the supervisor can print them
    even if a later optional stage wedges."""
    from vampomi_tpu.engine.linear import (
        _iteration_phase, _iteration_phase_eigen, _iteration_phase_spectral,
    )
    from vampomi_tpu.ops.operator import atx, normal_eq_mult
    from vampomi_tpu.ops.spectral import build_spectral, default_nb, shift_inverse

    tag = _dtype_name(dtype)

    def stage(name, max_s):
        tracker.stage(f"{tag}:{name}", max_s)

    wd = jnp.float32 if dtype in (jnp.bfloat16, jnp.int8, jnp.uint8) else dtype

    # scalar operands shared by the compile-ahead pool and the measurement
    # calls below — constructed ONCE so the avals are identical by identity
    gam1 = jnp.asarray(1.0)
    gamw = jnp.asarray(10.0)
    rho = jnp.asarray(0.5)
    damp = jnp.asarray(False)
    cg_max = jnp.asarray(500)   # reference defaults, src/options.hpp:83-84
    cg_tol = jnp.asarray(1e-5 if dtype == jnp.float32 else 1e-3)

    @jax.jit
    def dense_piece_sp(fv, t, g):
        winv = shift_inverse(fv, t, g, nb=default_nb(n))
        return winv.W

    nev = jax.jit(lambda d, v: normal_eq_mult(d, v, gamw, gam1))

    # ---- compile-ahead: the essentials path otherwise SERIALIZES its big
    # phase compiles (operator matvec -> spectral dense piece -> spectral
    # iteration -> CG iteration; each a cold compile).  AOT-lower ALL of them on background threads BEFORE the
    # problem even exists — every array operand is a ShapeDtypeStruct with
    # the exact aval make_problem will produce (locked by
    # tests/test_bench_helpers.py) — so they land in the persistent-cache
    # keys the measurements look up, and the whole compile set overlaps the
    # problem generation + its own compile.  Failures are harmless: the
    # main thread just compiles as before. ----
    ca_pool = None
    if os.environ.get("VAMPOMI_BENCH_NO_COMPILE_AHEAD") != "1":
        import concurrent.futures as _fut

        from vampomi_tpu.ops.eigen import EigenFactor
        from vampomi_tpu.ops.operator import DesignMatrix
        from vampomi_tpu.ops.spectral import GramFactor
        from vampomi_tpu.prior.mixture import init_prior

        def sds(shape, dt):
            return jax.ShapeDtypeStruct(shape, dt)

        cols = n // 2 if dtype == jnp.uint8 else n
        dm_s = DesignMatrix(
            X=sds((m, cols), dtype), mave=sds((m,), wd), msig=sds((m,), wd),
            mmask=sds((m,), wd), inv_sqrt_n=sds((), wd),
            n=sds((), jnp.float64), mt=sds((), jnp.float64),
        )
        prior_s = init_prior([0.9, 0.07, 0.03], [0.0, 1e-3, 1e-2], n)
        mv = sds((m,), wd)      # r1 / aty / ts / x1_prev / mu0 / bern
        yv = sds((n,), wd)
        fac_s = GramFactor(K=sds((n, n), wd))
        ef_s = EigenFactor(U=sds((n, n), wd), lam=sds((n,), jnp.float64))

        def _lower(label, fn, *args):
            def run():
                t0 = time.perf_counter()
                try:
                    fn.lower(*args).compile()
                    log(f"[compile-ahead] {label} ready "
                        f"({time.perf_counter() - t0:.1f}s)")
                except Exception as e:
                    log(f"[compile-ahead] {label} failed "
                        f"({type(e).__name__}: {e}) — main thread will "
                        f"compile it")
            return run

        _ca_items = [
            _lower("matvec", nev, dm_s, mv),
            _lower("spectral-dense", dense_piece_sp, fac_s, gamw, gam1),
            _lower("spectral-iteration", _iteration_phase_spectral,
                   dm_s, fac_s, mv, yv, mv, gam1, prior_s, mv, damp,
                   rho, gamw, mv),
            _lower("cg-iteration", _iteration_phase,
                   dm_s, mv, yv, mv, gam1, prior_s, mv, damp, rho,
                   gamw, mv, mv, mv, cg_max, cg_tol),
        ]
        if headline and dtype in (jnp.int8, jnp.uint8):
            _ca_items.append(_lower(
                "eigen-iteration", _iteration_phase_eigen,
                dm_s, ef_s, mv, yv, mv, gam1, prior_s, mv, damp, rho,
                gamw, mv))
        ca_pool = _fut.ThreadPoolExecutor(max_workers=5,
                                          thread_name_prefix="compile-ahead")
        for item in _ca_items:
            ca_pool.submit(item)

    stage("problem", 420)
    dm, y, r1, prior = make_problem(m, n, dtype)
    sync(dm.X)
    ts = jnp.zeros(m, dtype=wd)
    x1_prev = jnp.zeros(m, dtype=wd)
    key = jax.random.PRNGKey(1)
    # divide by a wd scalar: a numpy-f64 scalar would silently promote the
    # M-length probe to f64 (dtype-policy violation + a compile-ahead aval
    # mismatch — caught by tests/test_bench_helpers.py)
    bern = (jax.random.rademacher(key, (m,), dtype=wd)
            * jnp.asarray(1.0 / np.sqrt(float(m)), dtype=wd))
    mu0 = jnp.zeros(m, dtype=wd)

    # ---- north-star metric: LMMSE matvec GB/s (one A^T A v = 2 passes) ----
    # dm must be an ARGUMENT, not a closure capture: captured operands lower
    # as multi-GB inline constants
    stage("matvec", 360)
    t_mv = time_calls(lambda: nev(dm, r1), k=10)
    matvec_gbps = 2 * m * n * _itemsize(dtype) / t_mv / 1e9
    log(f"LMMSE matvec (A^T A v): {t_mv*1e3:.2f} ms = "
        f"{matvec_gbps:.0f} GB/s over the {tag} X (2 HBM passes)")

    # ---- spectral path: exact LMMSE via the per-iteration Gram factor ----
    stage("gram", 360)
    t0 = time.perf_counter()
    fac = build_spectral(dm)
    sync(fac.K)
    t_build = time.perf_counter() - t0
    log(f"gram build: {t_build:.2f}s (once per dataset)")
    aty = jax.jit(atx)(dm, y)

    stage("spectral", 540)
    t_dense = time_calls(lambda: dense_piece_sp(fac, gamw, gam1), k=5)
    log(f"factor dense piece (shift_inverse): {t_dense*1e3:.2f} ms")

    def ours_spectral():
        return _iteration_phase_spectral(
            dm, fac, aty, y, r1, gam1, prior, x1_prev, damp, rho, gamw, ts,
        )["x1_hat"]

    t_ours = time_calls(ours_spectral)
    solver = "spectral"
    log(f"spectral: iteration {t_ours*1e3:.1f} ms")

    # ---- reference-structured path: warm-started CG + Hutchinson probe ----
    # (cg_tol 1e-3 for narrow dtypes = the achievable residual floor — the
    # baseline gets the benefit of the doubt vs the reference's 1e-5 ask)
    stage("cg", 540)

    def ref_once(g1v, gwv, mu_warm):
        return _iteration_phase(
            dm, aty, y, r1, g1v, prior, x1_prev, damp, rho, gwv,
            mu_warm, bern, ts, cg_max, cg_tol,
        )

    # Warm start like a real run: the previous iteration solved the system at
    # slightly different gammas (src/vamp.cpp:308-311 reuses mu_CG_last across
    # iterations whose gam2/gamw have moved).  Warm-starting with the exact
    # solution of the SAME system would be unfairly fast for the baseline.
    prev = ref_once(gam1 * 1.15, gamw * 1.15, mu0)
    mu_warm = prev["x2_hat"]

    def ref():
        return ref_once(gam1, gamw, mu_warm)["x1_hat"]

    t_ref = time_calls(ref, k=3)
    cg_iters = int(ref_once(gam1, gamw, mu_warm)["cg_iters"])
    log(f"cg (reference structure): iteration {t_ref*1e3:.1f} ms "
        f"({cg_iters} warm-started CG iters at tol {float(cg_tol):g})")

    def result_dict():
        return {
            "metric": "vamp_iter_per_s",
            "value": round(1.0 / t_ours, 3),
            "unit": f"full VAMP iterations/s at M={m}, N={n}, {tag} "
                    f"({solver} LMMSE)",
            "vs_baseline": round(t_ref / t_ours, 3),
            "matvec_gbps": round(matvec_gbps, 1),
            "dense_ms": round(t_dense * 1e3, 2),
        }

    # ESSENTIALS DONE — a certified line exists from here on
    if headline:
        tracker.record(result_dict())

    # ---- optional upgrade: eigen-LMMSE (once-per-dataset diagonalization,
    # per-iteration dense work two N^2 matvecs instead of ~2N^3/3) ----
    eigen_reserve = 150.0  # timing + regeneration after a successful build
    eigen_est = float(os.environ.get("VAMPOMI_BENCH_EIGEN_EST", "480"))
    cache = os.path.join(
        tempfile.gettempdir(),
        f"vampomi_bench_eigen_{os.getuid()}_{m}_{n}_{np.dtype(dtype).name}.npz")
    warm = os.path.exists(cache)
    remaining = deadline - time.time()
    want_eigen = headline and dtype in (jnp.int8, jnp.uint8) and (
        remaining > (180.0 if warm else eigen_est) + eigen_reserve)
    if headline and dtype in (jnp.int8, jnp.uint8) and not want_eigen:
        log(f"eigen upgrade skipped: {remaining:.0f}s of budget left, "
            f"cache {'warm' if warm else 'cold'} (est {eigen_est:.0f}s) — "
            f"keeping the spectral-solver result")
    if want_eigen:
        from vampomi_tpu.ops.eigen import (
            EigenBuildTimeout, build_eigen_cached, eigen_weights,
        )

        stage("eigen", min(remaining, eigen_est * 2) + 90)
        # free X for the duration of the dense build (the build needs only
        # K); regenerate it bit-identically afterwards, so the build's N^2
        # transients never sit next to a 10+ GB X.
        placeholder = jnp.zeros(
            (16384, n // 2 if dtype == jnp.uint8 else n), dtype=dtype)
        dm = dm._replace(X=placeholder)
        import gc

        gc.collect()
        try:
            t0 = time.perf_counter()
            ef, diag = build_eigen_cached(
                fac, cache, verbose=True, deadline=deadline - eigen_reserve)
            sync(ef.U)
            t_eig = time.perf_counter() - t0
            log(f"eigen {'load' if diag.get('loaded') else 'build'}: "
                f"{t_eig:.1f}s (once per dataset; residual "
                f"{diag['resid']:.2e}, ortho {diag['ortho']:.2e})")
            if diag["resid"] > 1e-3:
                raise RuntimeError(f"eigen residual {diag['resid']} out of spec")
        except EigenBuildTimeout as e:
            log(f"eigen build hit the bench deadline ({e}) — keeping the "
                f"spectral-solver result")
            ef = None
        if ef is not None:
            del fac
            dm = dm._replace(X=gen_x(m, n, dtype))

            # dense_ms: the per-iteration non-X dense work in isolation
            @jax.jit
            def dense_piece_ei(efv, vv, t, g):
                d, T = eigen_weights(efv, t, g)
                with jax.default_matmul_precision("highest"):
                    q = efv.U @ (d.astype(jnp.float32) * (efv.U.T @ vv))
                return q, T

            t_dense = time_calls(lambda: dense_piece_ei(ef, y, gamw, gam1)[0],
                                 k=10)
            log(f"eigen dense piece (2 N^2 matvecs + traces): "
                f"{t_dense*1e3:.2f} ms")

            def ours_eigen():
                return _iteration_phase_eigen(
                    dm, ef, aty, y, r1, gam1, prior, x1_prev, damp, rho,
                    gamw, ts,
                )["x1_hat"]

            t_eigen_it = time_calls(ours_eigen)
            log(f"eigen: iteration {t_eigen_it*1e3:.1f} ms")
            if t_eigen_it < t_ours:
                t_ours, solver = t_eigen_it, "eigen"
                tracker.record(result_dict())
        else:
            dm = dm._replace(X=gen_x(m, n, dtype))

    if ca_pool is not None:
        ca_pool.shutdown(wait=False, cancel_futures=True)
    xbytes = m * n * _itemsize(dtype)
    log(f"shape: M={m}, N={n}, dtype={tag}; X = {xbytes/2**30:.2f} GiB; "
        f"solver = {solver}")
    return result_dict()


def child_main(state_path):
    _child_imports()
    tracker = StageTracker(state_path)
    deadline = float(os.environ.get(DEADLINE_ENV, T0 + BUDGET))

    # int8 X (vectors f32) is the capacity configuration: 1 byte/element
    # reaches the literal north-star M >= 1e6 x N >= 1e4 on one device.
    # tools/int8_accuracy.py compares its trajectory with f32.
    dtype = {
        "float32": jnp.float32,
        "bfloat16": jnp.bfloat16,
        "int8": jnp.int8,
        # packed int4 (two codes/byte): twice the int8 marker capacity
        "int4": jnp.uint8,
    }.get(os.environ.get("VAMPOMI_BENCH_DTYPE", "int8"), jnp.int8)
    # debug escape: VAMPOMI_BENCH_SHAPE=M,N runs an arbitrary (small) shape
    # so the bench path itself can be smoke-tested on the CPU
    shape_env = os.environ.get("VAMPOMI_BENCH_SHAPE", "")
    if shape_env:
        m, n = (int(v) for v in shape_env.split(","))
    else:
        m, n = pick_shape(dtype)
    while True:
        try:
            result = run_config(m, n, dtype, tracker, deadline, headline=True)
            break
        except Exception as e:  # RESOURCE_EXHAUSTED -> back off and retry
            if "RESOURCE_EXHAUSTED" not in str(e) or m <= 16384:
                raise
            # back off by 64k markers per retry (fine steps near the memory
            # ceiling; each retry pays full recompiles, so the budget
            # heuristic is tuned to need at most one)
            m = max(m - 4 * 16384, 16384)
            log(f"OOM; retrying with M={m}")
            # the failed attempt's device buffers are pinned by the
            # exception's traceback frames until GC breaks the cycles —
            # without this every retry OOMs instantly (measured)
            import gc

            e = None
            gc.collect()
            time.sleep(3.0)
    tracker.record(result)

    # ---- cross-round f32 companion, same invocation (round-3 ask #10) ----
    remaining = deadline - time.time()
    comp_est = float(os.environ.get("VAMPOMI_BENCH_COMPANION_EST", "420"))
    if (dtype != jnp.float32
            and os.environ.get("VAMPOMI_BENCH_NO_COMPANION") != "1"
            and not shape_env
            and remaining > comp_est):
        try:
            cm, cn = pick_shape(jnp.float32)
            comp = run_config(cm, cn, jnp.float32, tracker, deadline,
                              headline=False)
            log(f"f32 companion: {json.dumps(comp)}")
            comp_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                     "BENCH_F32_COMPANION.json")
            with open(comp_path, "w") as f:
                json.dump({
                    "companion": comp,
                    "purpose": "Cross-round comparability: the headline bench "
                               "runs int8 at the literal north-star shape, so "
                               "this records the f32/spectral configuration "
                               "at the reference CG tolerance 1e-5, emitted "
                               "by the SAME bench invocation (round-3 review "
                               "ask #10).",
                }, f, indent=1)
        except Exception as e:
            log(f"f32 companion failed ({type(e).__name__}: {e}) — headline "
                f"result unaffected")
    else:
        log(f"f32 companion skipped ({remaining:.0f}s of budget left, "
            f"est {comp_est:.0f}s)")

    tracker.finish()
    if not state_path:
        # unsupervised debug mode prints its own line
        print(json.dumps(result))


def supervise():
    """jax-free parent: run the child under stage-level liveness watching,
    retry on hang/crash, print the best recorded result.

    SIGTERM/SIGINT (e.g. the DRIVER's own `timeout` firing before our
    budget) prints the best result recorded so far and exits 0 — an
    externally imposed deadline must degrade to the essentials-first
    number, never to silence."""
    import signal

    state_path = os.path.join(
        tempfile.gettempdir(), f"vampomi_bench_state_{os.getpid()}.json")
    deadline = T0 + BUDGET
    best = None
    attempt = 0

    current = {"proc": None}

    def _terminated(signum, frame):
        st = _read_state(state_path) or {}
        result = st.get("result") or best
        log(f"supervisor: signal {signum} — emitting "
            f"{'best recorded result' if result else 'nothing (no result yet)'}")
        if current["proc"] is not None and current["proc"].poll() is None:
            current["proc"].kill()  # don't orphan the measuring child
        if result:
            print(json.dumps(result), flush=True)
            os._exit(0)
        os._exit(1)

    signal.signal(signal.SIGTERM, _terminated)
    signal.signal(signal.SIGINT, _terminated)
    while attempt < 3:
        attempt += 1
        if deadline - time.time() < 60:
            break
        # a stale state file from a killed attempt would trip the overdue
        # check before the fresh child writes its first heartbeat
        try:
            os.unlink(state_path)
        except OSError:
            pass
        env = dict(os.environ)
        env[STATE_ENV] = state_path
        env[DEADLINE_ENV] = str(deadline - 20.0)
        log(f"supervisor: starting child (attempt {attempt}, "
            f"{deadline - time.time():.0f}s of budget left)")
        proc = subprocess.Popen(
            [sys.executable, "-u", os.path.abspath(__file__)],
            env=env, stdout=sys.stderr, stderr=sys.stderr)
        current["proc"] = proc
        while True:
            rc = proc.poll()
            st = _read_state(state_path) or {}
            if st.get("result"):
                best = st["result"]
            if rc is not None:
                break
            now = time.time()
            overdue = (st and "stage_start" in st
                       and now > st["stage_start"] + st.get("stage_max", 600))
            if now > deadline - 15 or overdue:
                why = ("budget exhausted" if now > deadline - 15 else
                       f"stage '{st.get('stage', '?')}' exceeded its "
                       f"{st.get('stage_max', 600):.0f}s budget (hang)")
                log(f"supervisor: killing child — {why}")
                proc.kill()
                proc.wait()
                break
            time.sleep(5)
        st = _read_state(state_path) or {}
        if st.get("result"):
            best = st["result"]
        if st.get("done") or proc.returncode == 0:
            break
        if time.time() > deadline - 60:
            break
        log("supervisor: child did not finish cleanly — retrying")
    try:
        os.unlink(state_path)
    except OSError:
        pass
    if best:
        print(json.dumps(best))
        return 0
    log("supervisor: no result produced within the budget")
    return 1


def main() -> int:
    if os.environ.get(STATE_ENV):
        child_main(os.environ[STATE_ENV])
        return 0
    if os.environ.get("VAMPOMI_BENCH_NO_SUPERVISE") == "1":
        child_main("")
        return 0
    return supervise()


if __name__ == "__main__":
    sys.exit(main())

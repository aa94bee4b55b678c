"""Guards for bench.py's helper logic.

The benchmark frees the 10+ GB design matrix during the eigen build and
REGENERATES it from the PRNG key afterwards — that trick is only sound if
generation is bit-deterministic, which this locks.  (bench.py is the
driver-facing perf contract; its helpers deserve the same test coverage as
package code.)
"""

import sys
import os

import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench  # noqa: E402

# bench defers its jax imports to the measuring child process (the
# supervisor parent must stay jax-free); tests play the child
bench._child_imports()


def test_gen_x_is_deterministic():
    a = np.asarray(bench.gen_x(32768, 64, jnp.int8))
    b = np.asarray(bench.gen_x(32768, 64, jnp.int8))
    np.testing.assert_array_equal(a, b)
    assert a.dtype == np.int8
    c = np.asarray(bench.gen_x(16384, 64, jnp.bfloat16).astype(jnp.float32))
    d = np.asarray(bench.gen_x(16384, 64, jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_array_equal(c, d)


def test_make_problem_shapes_and_scaling():
    dm, y, r1, prior = bench.make_problem(16384, 64, jnp.int8)
    assert dm.X.dtype == jnp.int8 and dm.X.shape == (16384, 64)
    assert dm.wd == jnp.float32
    # msig folds the uniform-code sd so A rows are ~unit variance
    col = np.asarray(dm.X[:, 0], dtype=np.float64) * float(dm.msig[0])
    assert 0.8 < col.std() < 1.2
    assert y.shape == (64,) and r1.shape == (16384,)


def test_supervisor_kills_hung_child_and_retries(tmp_path):
    """The cold-start contract's core promise (a child that hangs
    mid-stage must not take the whole bench with it): a child wedged past its stage budget is killed, a fresh child is
    retried, and the bench still prints its one JSON line with rc=0."""
    import json
    import subprocess

    marker = tmp_path / "hang_once"
    env = dict(
        os.environ,
        JAX_PLATFORMS="cpu",
        VAMPOMI_BENCH_SHAPE="16384,256",
        VAMPOMI_BENCH_BUDGET="600",
        VAMPOMI_BENCH_NO_COMPANION="1",
        VAMPOMI_BENCH_TEST_HANG_STAGE="int8:gram",
        VAMPOMI_BENCH_TEST_HANG_ONCE=str(marker),
        # Must cover a COLD stage: on jax 0.9.0 this host never loads
        # XLA:CPU entries from the persistent cache (the AOT loader's
        # machine check trips on its own prefer-no-gather/scatter tuning
        # pseudo-features and recompiles), so every child pays full
        # compiles.  5s assumed warm loads and killed healthy children
        # at 'int8:problem' before the injected hang ever fired.
        VAMPOMI_BENCH_TEST_STAGE_MAX="60",
    )
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run(
        [sys.executable, os.path.join(repo, "bench.py")],
        env=env, capture_output=True, text=True, timeout=560, cwd=repo,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    line = r.stdout.strip().splitlines()[-1]
    result = json.loads(line)
    assert result["metric"] == "vamp_iter_per_s" and result["value"] > 0
    assert "killing child" in r.stderr      # the hang was detected
    assert "attempt 2" in r.stderr          # and a fresh child recovered
    assert marker.exists()                  # the hook fired exactly once


def test_supervisor_sigterm_emits_best_result(tmp_path):
    """An EXTERNAL deadline (the driver's own `timeout` firing before the
    bench budget) must degrade to the essentials-first number, not to
    silence: SIGTERM makes the supervisor print the best recorded result
    and exit 0."""
    import json
    import signal
    import subprocess
    import tempfile
    import time as _time

    env = dict(
        os.environ,
        JAX_PLATFORMS="cpu",
        VAMPOMI_BENCH_SHAPE="16384,256",
        VAMPOMI_BENCH_BUDGET="600",
        VAMPOMI_BENCH_NO_COMPANION="1",
        # force the eigen upgrade stage to start (est 1s fits any budget)
        # and hang inside it, so the TERM deterministically arrives AFTER
        # the essentials result exists but BEFORE the child finishes
        VAMPOMI_BENCH_EIGEN_EST="1",
        VAMPOMI_BENCH_TEST_HANG_STAGE="int8:eigen",
    )
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen(
        [sys.executable, os.path.join(repo, "bench.py")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, cwd=repo,
    )
    state = os.path.join(tempfile.gettempdir(),
                         f"vampomi_bench_state_{proc.pid}.json")
    deadline = _time.time() + 300
    result_seen = False
    while _time.time() < deadline:
        try:
            with open(state) as f:
                if (json.load(f) or {}).get("result"):
                    result_seen = True
                    break
        except Exception:
            pass
        _time.sleep(0.5)
    assert result_seen, "state file never recorded an essentials result"
    proc.send_signal(signal.SIGTERM)
    out, err = proc.communicate(timeout=60)
    assert proc.returncode == 0, err[-1000:]
    result = json.loads(out.strip().splitlines()[-1])
    assert result["metric"] == "vamp_iter_per_s" and result["value"] > 0


def test_compile_ahead_avals_match_measurement_calls():
    """The compile-ahead pool lowers the phase jits with ShapeDtypeStruct
    stand-ins for the two arrays that don't exist yet (fac.K, aty); those
    lowerings must be IDENTICAL to the concrete-args lowerings the
    measurement path dispatches — otherwise the AOT compile is a wasted
    cache entry and the main thread recompiles cold."""
    import jax

    from vampomi_tpu.engine.linear import (
        _iteration_phase, _iteration_phase_spectral,
    )
    from vampomi_tpu.ops.operator import atx
    from vampomi_tpu.ops.spectral import GramFactor, build_spectral

    m, n = 16384, 128
    dm, y, r1, prior = bench.make_problem(m, n, jnp.int8)
    wd = dm.wd
    gam1 = jnp.asarray(1.0)
    gamw = jnp.asarray(10.0)
    rho = jnp.asarray(0.5)
    damp = jnp.asarray(False)
    ts = jnp.zeros(m, dtype=wd)
    x1_prev = jnp.zeros(m, dtype=wd)
    key = jax.random.PRNGKey(1)
    bern = (jax.random.rademacher(key, (m,), dtype=wd)
            * jnp.asarray(1.0 / np.sqrt(float(m)), dtype=wd))
    cg_max = jnp.asarray(500)
    cg_tol = jnp.asarray(1e-3)
    mu0 = jnp.zeros(m, dtype=wd)

    fac = build_spectral(dm)
    aty = jax.jit(atx)(dm, y)

    # the pool's stand-ins: FULLY abstract DesignMatrix/vectors, exactly as
    # bench.run_config builds them before make_problem
    from vampomi_tpu.ops.operator import DesignMatrix
    from vampomi_tpu.prior.mixture import init_prior

    def sds(shape, dt):
        return jax.ShapeDtypeStruct(shape, dt)

    dm_s = DesignMatrix(
        X=sds((m, n), jnp.int8), mave=sds((m,), wd), msig=sds((m,), wd),
        mmask=sds((m,), wd), inv_sqrt_n=sds((), wd),
        n=sds((), jnp.float64), mt=sds((), jnp.float64),
    )
    prior_s = init_prior([0.9, 0.07, 0.03], [0.0, 1e-3, 1e-2], n)
    mv = sds((m,), wd)
    yv = sds((n,), wd)
    fac_s = GramFactor(K=sds((n, n), wd))

    a = _iteration_phase_spectral.lower(
        dm_s, fac_s, mv, yv, mv, gam1, prior_s, mv, damp, rho, gamw, mv)
    b = _iteration_phase_spectral.lower(
        dm, fac, aty, y, r1, gam1, prior, x1_prev, damp, rho, gamw, ts)
    assert a.as_text() == b.as_text()

    c = _iteration_phase.lower(
        dm_s, mv, yv, mv, gam1, prior_s, mv, damp, rho, gamw,
        mv, mv, mv, cg_max, cg_tol)
    d = _iteration_phase.lower(
        dm, aty, y, r1, gam1, prior, x1_prev, damp, rho, gamw,
        mu0, bern, ts, cg_max, cg_tol)
    assert c.as_text() == d.as_text()
    # ...and the warm-start call's scaled gammas keep the same avals
    e = _iteration_phase.lower(
        dm, aty, y, r1, gam1 * 1.15, prior, x1_prev, damp, rho, gamw * 1.15,
        mu0, bern, ts, cg_max, cg_tol)
    assert e.as_text() == d.as_text()

"""Host loop + GMRM-format outputs for the Gibbs sampler.

Output contracts (what the reference's consumers parse):
  - CSV, one row per sweep, GMRM column convention (the reference's
    conf_gibbs_init parses row[2]=sigma_g, row[3]=sigma_e, row[4]=h2,
    row[5]=m_incl, row[7]=L, row[8+i]=pi_i — /root/reference/scripts/
    conf_gibbs_init.py:70-78): [iteration, mu, sigma_g_file, sigma_e, h2,
    m_incl, vg, L, pi_0..pi_{L-1}] — columns 1 and 6 are informational.
  - .bet stream (scripts/pip.py): uint32 marker count, then per sweep
    [uint32 iteration, Mt float64 betas] in FILE units (beta = x/√N).
    `thin` > 1 keeps only every thin-th sweep — note the reference pip.py
    normalizes PIP by the ITERATION-number span, so feed it thin=1 streams
    (the default) or scale its output by `thin` yourself.
  - .grm group-mixtures file (conf_gibbs_init -grm): one line of
    space-separated FILE-unit component variances — the posterior-mean
    sigma_g times the ladder ratios — so the emitted .conf carries a fully
    data-derived prior.
"""

from __future__ import annotations

import os
import struct
import time
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.operator import DesignMatrix
from .sampler import (
    GibbsState,
    build_block_grams,
    decade_cvars,
    gibbs_sweep,
    init_state,
    sweep_stats,
)


class GibbsResult(NamedTuple):
    x_mean_file: np.ndarray    # posterior-mean beta (file units), length Mt
    pip: np.ndarray            # posterior inclusion prob, length Mt
    sigma_g_mean: float        # file units, over the averaging window
    sigma_e_mean: float
    h2_mean: float
    pi_mean: np.ndarray
    csv_path: str | None
    bet_path: str | None
    grm_path: str | None
    sweeps: int


def run_gibbs(
    dm: DesignMatrix,
    y: np.ndarray,
    iterations: int = 500,
    burnin: int | None = None,
    l_comp: int = 4,
    block: int = 256,
    thin: int = 1,
    h2_init: float = 0.5,
    seed: int = 0,
    out_dir: str | None = None,
    out_name: str = "gibbs",
    verbose: bool = True,
) -> GibbsResult:
    """Run `iterations` systematic-scan sweeps; average over the post-burnin
    window (default: second half)."""
    n = int(dm.n)
    mt = int(dm.mt)
    sqrt_n = float(np.sqrt(n))
    if burnin is None:
        burnin = iterations // 2
    if dm.m_pad % block != 0:
        # block must divide the padded marker count; shrink to a divisor
        while dm.m_pad % block != 0:
            block //= 2
    cvars = jnp.asarray(decade_cvars(l_comp), dtype=jnp.float64)

    state = init_state(dm, y, l_comp, h2_init=h2_init)

    t0 = time.time()
    grams = build_block_grams(dm, block=block)
    grams.block_until_ready()
    if verbose:
        print(f"[gibbs] {dm.m_pad // block} block Grams (B={block}) in "
              f"{time.time() - t0:.2f}s", flush=True)

    y_dev = jnp.asarray(np.asarray(y, dtype=np.float64), dtype=dm.wd)

    csv_path = bet_path = grm_path = None
    csv_f = bet_f = None
    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        csv_path = os.path.join(out_dir, f"{out_name}.csv")
        bet_path = os.path.join(out_dir, f"{out_name}.bet")
        grm_path = os.path.join(out_dir, f"{out_name}.grm")
        csv_f = open(csv_path, "w")
        bet_f = open(bet_path, "wb")
        bet_f.write(struct.pack("I", mt))

    key = jax.random.PRNGKey(seed)
    x_sum = np.zeros(mt)
    pip_cnt = np.zeros(mt)
    navg = 0
    sg_sum = se_sum = h2_sum = 0.0
    pi_sum = np.zeros(l_comp)

    t_loop = time.time()
    for it in range(1, iterations + 1):
        key, ks = jax.random.split(key)
        state = gibbs_sweep(dm, grams, state, cvars, ks, block=block)
        h2, m_incl, vg = sweep_stats(dm, state, y_dev)

        # ONE pytree fetch per sweep: every device_get is a host round
        # trip that drains the device queue, so h2/m_incl/sigma_g/sigma_e/
        # pi/mu come back together; the M-length x fetch stays gated on
        # thinned/averaging sweeps
        h2, m_incl, vg_h, sg, se, pi, mu_h = jax.device_get(
            (h2, m_incl, vg, state.sigma_g, state.sigma_e, state.pi,
             state.mu))
        h2 = float(h2)
        m_incl = int(m_incl)
        vg = float(vg_h)
        sg = float(sg) / n                  # internal -> file units
        se = float(se)
        pi = np.asarray(pi, dtype=np.float64)

        if csv_f is not None:
            row = [it, f"{float(mu_h):.10g}", f"{sg:.10g}", f"{se:.10g}",
                   f"{h2:.10g}", m_incl, f"{vg:.10g}", l_comp]
            row += [f"{p:.12f}" for p in pi]
            csv_f.write(",".join(str(v) for v in row) + "\n")

        thinned = it % thin == 0
        in_window = it > burnin
        if thinned or in_window:
            x_host = np.asarray(
                jax.device_get(state.x), dtype=np.float64)[:mt] / sqrt_n
        if thinned and bet_f is not None:
            bet_f.write(struct.pack("I", it))
            bet_f.write(x_host.astype("<f8").tobytes())
        if in_window:
            x_sum += x_host
            pip_cnt += np.abs(x_host) > 0
            sg_sum += sg
            se_sum += se
            h2_sum += h2
            pi_sum += pi
            navg += 1
        if verbose and (it % 50 == 0 or it == 1):
            print(f"[gibbs] sweep {it}/{iterations}: h2={h2:.4f} "
                  f"m_incl={m_incl} sigma_e={se:.4f} "
                  f"({(time.time() - t_loop) / it:.3f}s/sweep)", flush=True)

    if csv_f is not None:
        csv_f.close()
    if bet_f is not None:
        bet_f.close()

    navg = max(navg, 1)
    sg_mean = sg_sum / navg
    if grm_path is not None:
        ladder = np.asarray(decade_cvars(l_comp)) * sg_mean
        with open(grm_path, "w") as f:
            f.write(" ".join(f"{v:.12g}" for v in ladder) + "\n")

    return GibbsResult(
        x_mean_file=x_sum / navg,
        pip=pip_cnt / navg,
        sigma_g_mean=sg_mean,
        sigma_e_mean=se_sum / navg,
        h2_mean=h2_sum / navg,
        pi_mean=pi_sum / navg,
        csv_path=csv_path,
        bet_path=bet_path,
        grm_path=grm_path,
        sweeps=iterations,
    )

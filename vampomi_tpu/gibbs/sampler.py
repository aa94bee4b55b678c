"""Spike-and-slab Gibbs sampler (the GMRMomi analog).

The reference ecosystem's documented production workflow warm-starts gVAMP
from a GMRMomi Gibbs run: scripts/conf_gibbs_init.py averages the sampler's
per-iteration CSV into a `.conf`, and scripts/pip.py reads its `.bet`
stream (reference README.md:170-213; the GMRM tool itself is external to
the reference repo — only its OUTPUT formats are contracts here).  This
module provides that MCMC stage natively, so the whole workflow runs inside
the framework.

Model (BayesR-type, matching the gVAMP prior family, src/vamp.cpp:440-463):

    y = mu + A x + e,   e ~ N(0, sigma_e I)
    x_j ~ pi_0 delta_0 + sum_k pi_k N(0, c_k sigma_g)       (internal scale)
    pi ~ Dirichlet(1),  sigma_g, sigma_e ~ scaled-inv-chi2

with A the standardized operator (ops/operator.py) and x internal-scale
(= beta * sqrt(N)), exactly the engine's conventions.

Design — the reference ecosystem's CPU samplers walk markers
serially with O(N) residual updates per marker (M*N sequential work per
sweep).  Single-site Gibbs is inherently sequential, but the O(N) inner
dependency is not: markers are processed in blocks of B with

  1. r_b = A_b y_resid               one streamed pass over X per sweep
  2. an on-device sequential scan over the B markers, correcting the local
     correlations through a PRECOMPUTED block Gram G_b = A_b A_b^T
     (c_loc <- c_loc - G[:,j] * dx, O(B) per marker instead of O(N))
  3. y_resid -= A_b^T dx_b           second streamed pass over X

so a full sweep costs exactly 2 passes over X — identical to a VAMP
iteration — plus M latency-bound O(B) steps, while remaining a
mathematically EXACT systematic-scan Gibbs chain (the block Gram makes the
within-block conditionals exact; blocks are processed sequentially against
the updated residual).  For int8 designs the Grams are computed EXACTLY via
int8xint8->int32 contractions plus rank-1 affine corrections.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.operator import DesignMatrix, atx, ax


class GibbsState(NamedTuple):
    x: jax.Array        # (M_pad,) internal-scale effects, work dtype
    comp: jax.Array     # (M_pad,) int32 component assignment, 0 = spike
    y_resid: jax.Array  # (N,)  y - mu - A x
    mu: jax.Array       # ()    intercept, f64
    sigma_g: jax.Array  # ()    slab scale (internal units), f64
    sigma_e: jax.Array  # ()    residual variance, f64
    pi: jax.Array       # (L,)  mixture weights, f64


def _block_dm(dm: DesignMatrix, b, block: int) -> DesignMatrix:
    """A DesignMatrix view of one marker block (all-tracer NamedTuple, valid
    under jit) so the block passes reuse ops.operator.ax/atx verbatim."""
    sl = lambda a: jax.lax.dynamic_slice_in_dim(a, b * block, block, 0)  # noqa: E731
    return DesignMatrix(
        X=sl(dm.X), mave=sl(dm.mave), msig=sl(dm.msig), mmask=sl(dm.mmask),
        inv_sqrt_n=dm.inv_sqrt_n, n=dm.n, mt=dm.mt,
    )


@functools.partial(jax.jit, static_argnames=("block",))
def build_block_grams(dm: DesignMatrix, block: int = 256) -> jax.Array:
    """(nb, B, B) f32 per-block Grams G_b = A_b A_b^T.

    int8 X: EXACT — Xq Xq^T in int8xint8->int32 (|sum| <= 127^2 * N < 2^31),
    then the standardization folded in as rank-1 corrections in f32:
        A A^T = D (Xq Xq^T - q1 m^T - m q1^T + N m m^T) D / N,
    with m = mave, D = diag(msig), q1 = Xq 1.  Other dtypes: direct f32
    product at HIGHEST precision.
    """
    nb = dm.m_pad // block

    # int8 codes contract exactly in int32 only while |sum| <= 127^2 * N
    # stays below 2^31 (N < ~133k samples); packed int4 codes are bounded by
    # 8^2 * N (N < ~33M).  Fail loudly instead of silently overflowing the
    # within-block corrections (round-3 advisor finding).
    if dm.X.dtype == jnp.int8 and dm.X.shape[1] * 127 * 127 >= 2**31:
        raise ValueError(
            f"int8 block-Gram would overflow its exact int32 accumulation at "
            f"N={dm.X.shape[1]} (limit {2**31 // (127 * 127)}); use a float "
            f"design dtype for the Gibbs stage at this sample count")

    def one(b):
        d = _block_dm(dm, b, block)
        if dm.X.dtype in (jnp.int8, jnp.uint8):
            if dm.X.dtype == jnp.uint8:
                # packed int4: unpack the block's codes to int8 — the
                # int8-exact product below then covers it (|sum| <= 64 N)
                from ..ops.operator import unpack_nibbles

                lo, hi = unpack_nibbles(d.X, dtype=jnp.int8)
                Xq = jnp.concatenate([lo, hi], axis=1)
            else:
                Xq = d.X
            S = jax.lax.dot_general(
                Xq, Xq, (((1,), (1,)), ((), ())),
                preferred_element_type=jnp.int32,
            ).astype(jnp.float32)
            q1 = jnp.sum(Xq.astype(jnp.float32), axis=1)
            m = d.mave
            S = S - jnp.outer(q1, m) - jnp.outer(m, q1) + d.n.astype(
                jnp.float32) * jnp.outer(m, m)
            G = d.msig[:, None] * S * d.msig[None, :] / d.n.astype(jnp.float32)
        else:
            wd = d.wd
            A = (d.X.astype(wd) - d.mave[:, None]) * d.msig[:, None] * d.inv_sqrt_n
            with jax.default_matmul_precision("highest"):
                G = jax.lax.dot_general(
                    A, A, (((1,), (1,)), ((), ())),
                    preferred_element_type=jnp.float32,
                ).astype(jnp.float32)
        return G.astype(jnp.float32)

    _, grams = jax.lax.scan(lambda c, b: (c, one(b)), 0, jnp.arange(nb))
    return grams


@functools.partial(jax.jit, static_argnames=())
def block_update(Gb, r0, xb0, mmask_b, u, z, pi, cvars, sigma_g, sigma_e):
    """Sequential spike-and-slab Gibbs over one block's markers, exact
    given the block Gram.  Pure function of pre-drawn randoms (u, z) so a
    numpy oracle can replicate it bit-for-bit (tests/test_gibbs.py).

    Returns (xb_new, comp_b_new).  Conditional per marker j (standard
    BayesR algebra; same stabilized log-space form as the engine's g1,
    reference src/vamp.cpp:440-463 for the eta_max trick):

      v_k = 1/(s_jj/sigma_e + 1/psi_k),  m_k = v_k r_j / sigma_e
      log l_0 = log pi_0
      log l_k = log pi_k + (log v_k - log psi_k)/2 + m_k^2/(2 v_k)
    """
    B = xb0.shape[0]
    psi = cvars * sigma_g                    # (L,) f64, psi[0] = 0
    log_pi = jnp.log(jnp.maximum(pi, 1e-300))
    safe_psi = jnp.where(psi > 0.0, psi, 1.0)

    def body(j, carry):
        c_loc, xb, compb = carry
        sjj = Gb[j, j].astype(jnp.float64)
        rj = c_loc[j].astype(jnp.float64) + sjj * xb[j].astype(jnp.float64)

        v = 1.0 / (sjj / sigma_e + 1.0 / safe_psi)
        m = v * rj / sigma_e
        logl = jnp.where(
            psi > 0.0,
            log_pi + 0.5 * (jnp.log(v) - jnp.log(safe_psi)) + 0.5 * m * m / v,
            log_pi,
        )
        logl = jnp.where(mmask_b[j] > 0.0, logl, jnp.where(psi > 0.0, -jnp.inf, 0.0))
        w = jnp.exp(logl - jnp.max(logl))
        cum = jnp.cumsum(w)
        k = jnp.sum(cum < u[j] * cum[-1]).astype(jnp.int32)

        xnew = jnp.where(
            psi[k] > 0.0, m[k] + jnp.sqrt(v[k]) * z[j].astype(jnp.float64), 0.0
        ) * mmask_b[j].astype(jnp.float64)
        d = (xnew - xb[j].astype(jnp.float64)).astype(c_loc.dtype)
        c_loc = c_loc - Gb[j] * d
        return c_loc, xb.at[j].set(xnew.astype(xb.dtype)), compb.at[j].set(k)

    c0 = r0.astype(jnp.float32)
    _, xb, compb = jax.lax.fori_loop(
        0, B, body, (c0, xb0, jnp.zeros(B, dtype=jnp.int32))
    )
    return xb, compb


@functools.partial(jax.jit, static_argnames=("block",),
                   donate_argnames=("state",))
def gibbs_sweep(
    dm: DesignMatrix,
    grams: jax.Array,
    state: GibbsState,
    cvars: jax.Array,          # (L,) f64 variance-ladder RATIOS, cvars[0]=0
    key,
    block: int = 256,
    nu0: float = 4.0,
    s0_g: float = 1.0,
    s0_e: float = 1.0,
) -> GibbsState:
    """One full systematic-scan sweep + hyperparameter draws."""
    nb = dm.m_pad // block
    n = state.y_resid.shape[0]
    wd = dm.wd

    def block_body(b, carry):
        x, comp, y_resid, key = carry
        d = _block_dm(dm, b, block)
        r0 = atx(d, y_resid)                           # pass 1 over X_b
        xb0 = jax.lax.dynamic_slice_in_dim(x, b * block, block, 0)
        kb = jax.random.fold_in(key, b)
        ku, kz = jax.random.split(kb)
        # work-dtype randoms (consumed as scalars in block_update; f32
        # resolution is far below MC error) — no M-length f64 vectors on
        # device (CLAUDE.md dtype policy)
        u = jax.random.uniform(ku, (block,), dtype=wd)
        z = jax.random.normal(kz, (block,), dtype=wd)
        Gb = grams[b]
        xb, compb = block_update(
            Gb, r0, xb0, d.mmask, u, z, state.pi, cvars,
            state.sigma_g, state.sigma_e,
        )
        y_resid = y_resid - ax(d, xb - xb0)            # pass 2 over X_b
        x = jax.lax.dynamic_update_slice_in_dim(x, xb, b * block, 0)
        comp = jax.lax.dynamic_update_slice_in_dim(comp, compb, b * block, 0)
        return x, comp, y_resid, key

    key, ksweep = jax.random.split(key)
    x, comp, y_resid, _ = jax.lax.fori_loop(
        0, nb, block_body, (state.x, state.comp, state.y_resid, ksweep)
    )

    # ---- intercept: mu | rest ~ N(mean(y_resid + mu), sigma_e / N) ----
    # vector math in the work dtype, scalars promoted to f64 at the
    # reduction boundary (house convention — engine/linear.py:132)
    key, kmu = jax.random.split(key)
    resid_mean = jnp.mean(y_resid).astype(jnp.float64) + state.mu
    mu = resid_mean + jnp.sqrt(state.sigma_e / n) * jax.random.normal(
        kmu, dtype=jnp.float64)
    y_resid = y_resid + (state.mu - mu).astype(wd)

    # ---- counts and sufficient stats (masked M-length reductions) ----
    l_comp = cvars.shape[0]
    mask_wd = dm.mmask.astype(wd)
    onehot = (comp[:, None] == jnp.arange(l_comp)[None, :]).astype(wd)
    onehot = onehot * mask_wd[:, None]
    # f32 sums count exactly up to 2^24 markers per component
    counts = jnp.sum(onehot, axis=0).astype(jnp.float64)   # (L,)
    m_incl = jnp.sum(counts[1:])

    xw = x.astype(wd)
    safe_c = jnp.where(cvars > 0.0, cvars, 1.0).astype(wd)  # (L,)
    xsq_over_c = jnp.where(comp > 0, xw * xw / safe_c[comp], 0.0)
    ssq_g = jnp.sum(xsq_over_c).astype(jnp.float64)

    # ---- sigma_g ~ scaled-inv-chi2(nu0 + m_incl, (ssq + nu0 s0)/(df)) ----
    key, kg, ke, kp = jax.random.split(key, 4)
    df_g = nu0 + m_incl
    chi_g = 2.0 * jax.random.gamma(kg, df_g / 2.0, dtype=jnp.float64)
    sigma_g = (ssq_g + nu0 * s0_g) / jnp.maximum(chi_g, 1e-12)

    rss = jnp.dot(y_resid, y_resid).astype(jnp.float64)
    df_e = nu0 + n
    chi_e = 2.0 * jax.random.gamma(ke, df_e / 2.0, dtype=jnp.float64)
    sigma_e = (rss + nu0 * s0_e) / jnp.maximum(chi_e, 1e-12)

    pi = jax.random.dirichlet(kp, 1.0 + counts)

    return GibbsState(
        x=x, comp=comp, y_resid=y_resid, mu=mu,
        sigma_g=sigma_g, sigma_e=sigma_e, pi=pi,
    )


@jax.jit
def sweep_stats(dm: DesignMatrix, state: GibbsState, y):
    """(h2, m_incl, vg) for the CSV row: vg = ||A x||^2 / N (A columns are
    exactly mean-zero, so this is the variance of the fitted genetic term)."""
    wd = state.y_resid.dtype
    g = y.astype(wd) - state.mu.astype(wd) - state.y_resid
    vg = jnp.dot(g, g).astype(jnp.float64) / g.shape[0]
    h2 = vg / (vg + state.sigma_e)
    m_incl = jnp.sum((state.comp > 0) & (dm.mmask > 0.0))
    return h2, m_incl, vg


def init_state(dm: DesignMatrix, y: np.ndarray, l_comp: int,
               h2_init: float = 0.5) -> GibbsState:
    """Cold start: x = 0, sigma_e = (1-h2) Var(y), sigma_g from h2."""
    n = int(dm.n)
    y64 = np.asarray(y, dtype=np.float64)
    vy = float(np.var(y64))
    mu0 = float(np.mean(y64))
    pi0 = np.full(l_comp, 0.01 / max(l_comp - 1, 1))
    pi0[0] = 0.99
    return GibbsState(
        x=jnp.zeros(dm.m_pad, dtype=dm.wd),
        comp=jnp.zeros(dm.m_pad, dtype=jnp.int32),
        y_resid=jnp.asarray(y64 - mu0, dtype=dm.wd),
        mu=jnp.asarray(mu0, dtype=jnp.float64),
        sigma_g=jnp.asarray(max(h2_init * vy, 1e-6), dtype=jnp.float64),
        sigma_e=jnp.asarray(max((1.0 - h2_init) * vy, 1e-6), dtype=jnp.float64),
        pi=jnp.asarray(pi0, dtype=jnp.float64),
    )


def decade_cvars(l_comp: int) -> np.ndarray:
    """Variance-ladder ratios [0, 1e-{L-2}, ..., 1e-1, 1]: component k's
    prior variance is cvars[k] * sigma_g, mirroring conf_gibbs_init's decade
    ladder (scripts/conf_gibbs_init.py get_vars)."""
    out = np.zeros(l_comp)
    out[1:] = 10.0 ** -(np.arange(l_comp - 1, 0, -1) - 1.0)
    return out

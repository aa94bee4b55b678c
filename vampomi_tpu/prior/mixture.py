"""Spike + Gaussian-mixture prior: MMSE denoisers and EM hyperparameter
updates, vectorized over (M, L).

Math follows the reference exactly, including its numerical stabilization:
the largest mixture variance ("eta_max") is factored out of every exponent so
arguments stay bounded where a naive form would overflow
(reference: src/vamp.cpp:440-492 g1/g1d, src/vamp.cpp:531-643 updatePrior).
The same factoring makes every exponent ≤ 0, which keeps the (M, L) math
safe in float32 — the work dtype on an accelerator (hyperparameters and
sufficient statistics stay f64, they are O(L) scalars).

Dynamic-shape policy: the reference erases merged mixture components from
std::vectors (src/vamp.cpp:627-642).  Under jit we keep a fixed component
count L with a boolean `active` mask; dead components carry prob = 0 and are
masked out of every sum and max.  The merge itself runs host-side on the tiny
(L,) arrays between iterations (`merge_components`).

Conventions: `vars` are the *internally scaled* variances (multiplied by N,
reference src/vamp.cpp:87-88); component 0 is the spike (vars[0] == 0 by
default) and is never merged away nor var-learned.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

_SIGMA_TINY = 1e-10  # reference: src/vamp.cpp:446 shortcut when 1/gam1 ~ 0


class MixturePrior(NamedTuple):
    """Pytree of mixture hyperparameters with a fixed max component count.
    probs/vars are f64 (O(L) scalars)."""

    probs: jax.Array   # (L,) f64, dead slots 0
    vars: jax.Array    # (L,) f64, scaled by N
    active: jax.Array  # (L,) bool

    @property
    def L(self) -> int:
        return self.probs.shape[0]


def _terms(y: jax.Array, gam1, prior: MixturePrior):
    """Common per-component quantities in y's dtype.

    Returns (sigma, v, z, pk_terms_mask) with z_j(y) = probs_j /
    sqrt(vars_j + sigma) * exp(stabilized exponent), 0 for inactive slots.
    """
    wd = y.dtype
    sigma = (1.0 / jnp.asarray(gam1, dtype=jnp.float64)).astype(wd)
    eta_max = jnp.max(jnp.where(prior.active, prior.vars, -jnp.inf)).astype(wd)
    v = prior.vars.astype(wd)[None, :]
    probs = prior.probs.astype(wd)[None, :]
    y2 = (y * y)[:, None]
    expo = -0.5 * y2 * (eta_max - v) / (v + sigma) / (eta_max + sigma)
    z = probs / jnp.sqrt(v + sigma) * jnp.exp(expo)
    z = jnp.where(prior.active[None, :], z, jnp.zeros((), wd))
    return sigma, v, z


def g1(y: jax.Array, gam1, prior: MixturePrior) -> jax.Array:
    """MMSE posterior-mean denoiser (reference src/vamp.cpp:440-463),
    vectorized over y (M,), computed in y's dtype.

    Algebraically identical to the reference's `y + sigma pk'/pk`, but in
    the SHRINKAGE form  g1 = y * sum_k w_k v_k/(v_k + sigma)  with posterior
    weights w_k = z_k / sum z.  The reference form computes y(1 - sigma
    sum w a) by cancellation: at cold start (gam1 = 1e-6, sigma = 1e6) the
    true factor ~1e-7 sits BELOW the f32 ulp at 1 and rounds to 0/6e-8 —
    the shrinkage form carries full relative precision at any sigma."""
    sigma, v, z = _terms(y, gam1, prior)
    pk = jnp.sum(z, axis=1)
    pk_safe = jnp.where(pk == 0.0, 1.0, pk)
    w = z / pk_safe[:, None]
    shrink = jnp.sum(w * (v / (v + sigma)), axis=1)
    # pk can underflow to 0 in f32 for huge |y| (every stabilized exponent
    # subnormal); the true posterior is then dominated by the max-variance
    # component, so fall back to its shrinkage factor rather than 0
    vmax = jnp.max(jnp.where(prior.active, prior.vars, -jnp.inf)).astype(y.dtype)
    shrink = jnp.where(pk == 0.0, vmax / (vmax + sigma), shrink)
    val = y * shrink
    return jnp.where(jnp.abs(sigma) < _SIGMA_TINY, y, val)


def g1d(y: jax.Array, gam1, prior: MixturePrior) -> jax.Array:
    """Derivative of g1 (reference src/vamp.cpp:465-492), in the stable form

        g1d = sum_k w_k v_k/(v_k+sigma) + sigma y^2 Var_w[1/(v+sigma)]

    (expand 1 + sigma(pkdd/pk - (pkd/pk)^2) with w_k, a_k = 1/(v_k+sigma):
    the '1 - sigma sum w a' piece is sum_k w_k v_k a_k exactly).  The
    reference's direct form loses alpha1 entirely in f32 at cold start —
    alpha1 = mean g1d ~ 4e-8 rounds to 0, making eta1 = gam1/alpha1
    infinite and NaN-ing the whole trajectory."""
    sigma, v, z = _terms(y, gam1, prior)
    a = 1.0 / (v + sigma)
    pk = jnp.sum(z, axis=1)
    pk_safe = jnp.where(pk == 0.0, 1.0, pk)
    w = z / pk_safe[:, None]
    shrink = jnp.sum(w * (v * a), axis=1)
    mean_a = jnp.sum(w * a, axis=1)
    # two-pass variance: the E[a^2]-E[a]^2 form cancels NEGATIVE in f32,
    # and the sigma y^2 amplifier (1e6 * y^2 at cold start) then drives
    # alpha1 < 0 -> eta1 < 0 -> clamp collapse (observed at production
    # scale in the probit engine); sum w (a - mean)^2 is >= 0 by construction
    var_a = jnp.sum(w * (a - mean_a[:, None]) ** 2, axis=1)
    val = shrink + sigma * (y * y) * var_a
    # pk underflow: posterior collapses onto the max-variance component
    # (zero posterior variance across components), matching g1's fallback
    vmax = jnp.max(jnp.where(prior.active, prior.vars, -jnp.inf)).astype(y.dtype)
    val = jnp.where(pk == 0.0, vmax / (vmax + sigma), val)
    return jnp.where(jnp.abs(sigma) < _SIGMA_TINY, jnp.ones_like(y), val)


def em_update(
    r1: jax.Array,
    gam1,
    prior: MixturePrior,
    mmask: jax.Array,
    mt,
    *,
    em_max_iter,
    em_err_thr,
    learn_vars,
    debug: bool = False,
) -> MixturePrior:
    """One call of the reference's `updatePrior` EM loop
    (src/vamp.cpp:531-643, minus the merge step — see `merge_components`).

    Distributed: when r1 is sharded over the marker mesh axis, the per-marker
    sums below contract the sharded dim, so XLA inserts the same scalar
    all-reduces the reference issues via MPI_Allreduce (src/vamp.cpp:578,
    596-597).  Padding markers are excluded via `mmask`.

    The (M, L) responsibilities are computed in r1's dtype; the O(L)
    hyperparameter arithmetic stays f64.
    """
    wd = r1.dtype
    gam1 = jnp.asarray(gam1, dtype=jnp.float64)
    noise_var64 = 1.0 / gam1
    noise_var = noise_var64.astype(wd)
    gam1_c = gam1.astype(wd)
    slab = jnp.logical_and(prior.active, jnp.arange(prior.L) >= 1)
    mmask_c = mmask.astype(wd)
    r2_half = (r1 * r1) * 0.5  # (M,)

    class EMState(NamedTuple):
        it: jax.Array
        probs: jax.Array  # f64
        vars: jax.Array   # f64
        done: jax.Array

    def body(s: EMState) -> EMState:
        probs64, vars64 = s.probs, s.vars
        lam64 = 1.0 - probs64[0]
        max_sigma64 = jnp.max(jnp.where(prior.active, vars64, -jnp.inf))
        max_sigma = max_sigma64.astype(wd)

        v_col = vars64.astype(wd)[None, :]
        probs_c = probs64.astype(wd)[None, :]
        num = (
            probs_c
            * jnp.exp(
                -r2_half[:, None] * (max_sigma - v_col) / (v_col + noise_var) / (max_sigma + noise_var)
            )
            / jnp.sqrt(v_col + noise_var)
            / jnp.sqrt(jnp.asarray(2.0 * np.pi, wd))
        )
        num = jnp.where(slab[None, :], num, jnp.zeros((), wd))
        sum_num = jnp.sum(num, axis=1)
        sum_safe = jnp.where(sum_num == 0.0, 1.0, sum_num)
        beta = num / sum_safe[:, None]

        # pin_i: posterior inclusion probability of marker i
        spike_term = (
            (1.0 - lam64).astype(wd)
            / jnp.sqrt(jnp.asarray(2.0 * np.pi, wd) * noise_var)
            * jnp.exp(-r2_half * max_sigma / noise_var / (noise_var + max_sigma))
        )
        pin = 1.0 / (1.0 + spike_term / sum_safe)
        pin = pin * mmask_c  # exclude padding markers from all stats

        lam_total = jnp.sum(pin).astype(jnp.float64)  # psum over marker axis
        lam_new = lam_total / mt

        v_safe = jnp.where(v_col == 0.0, 1.0, v_col)
        gmean = gam1_c * r1[:, None] / (1.0 / v_safe + gam1_c)
        v_post64 = 1.0 / (1.0 / jnp.where(vars64 == 0.0, 1.0, vars64) + gam1)
        gammas = beta * (gmean * gmean + v_post64.astype(wd)[None, :])

        res = jnp.sum(beta * pin[:, None], axis=0).astype(jnp.float64)
        res_gammas = jnp.sum(gammas * pin[:, None], axis=0).astype(jnp.float64)

        res_safe = jnp.where(res == 0.0, 1.0, res)
        new_vars = jnp.where(
            jnp.logical_and(slab, res != 0.0), res_gammas / res_safe, vars64
        )
        # learn_vars may be a traced bool; it gates the in-loop variance
        # update (reference src/vamp.cpp:598-599)
        vars_next = jnp.where(jnp.asarray(learn_vars), new_vars, vars64)
        omegas = jnp.where(slab, res / jnp.where(lam_total == 0.0, 1.0, lam_total), 0.0)
        probs_next = jnp.where(slab, lam_new * omegas, probs64)
        probs_next = probs_next.at[0].set(1.0 - lam_new)
        probs_next = jnp.where(prior.active, probs_next, 0.0)

        def masked_rel_dist(a, b):
            d = jnp.sum(jnp.where(prior.active, (a - b) ** 2, 0.0))
            n = jnp.sum(jnp.where(prior.active, a * a, 0.0))
            return jnp.sqrt(d / jnp.where(n == 0.0, 1.0, n))

        dist_probs = masked_rel_dist(probs_next, probs64)
        dist_vars = masked_rel_dist(vars_next, vars64)
        done = jnp.logical_and(dist_probs < em_err_thr, dist_vars < em_err_thr)

        if debug:
            # per-EM-iteration convergence narration (--verbosity 1;
            # reference src/vamp.cpp:615-617)
            jax.debug.print(
                "it = {i}: dist_probs = {p} & dist_vars = {v}",
                i=s.it, p=dist_probs, v=dist_vars,
            )

        return EMState(it=s.it + 1, probs=probs_next, vars=vars_next, done=done)

    def cond(s: EMState):
        return jnp.logical_and(s.it < em_max_iter, jnp.logical_not(s.done))

    init = EMState(
        it=jnp.asarray(0),
        probs=prior.probs,
        vars=prior.vars,
        done=jnp.asarray(False),
    )
    out = lax.while_loop(cond, body, init)
    return MixturePrior(probs=out.probs, vars=out.vars, active=prior.active)


def merge_components(
    probs: np.ndarray, vars_: np.ndarray, active: np.ndarray, merge_vars_thr: float
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host-side merge of near-duplicate variance components
    (reference: src/vamp.cpp:627-642).  The reference erases vector entries;
    we zero the prob and clear the active flag so jit shapes stay static.
    Returns new (probs, vars, active) numpy arrays.
    """
    probs = np.array(probs, dtype=np.float64)
    vars_ = np.array(vars_, dtype=np.float64)
    active = np.array(active, dtype=bool)
    L = len(probs)
    for j in range(L):
        if not active[j]:
            continue
        for k in range(j + 1, L):
            if not active[k]:
                continue
            denom = min(vars_[j], vars_[k]) if vars_[j] != 0 else 1e-7
            if denom == 0.0:
                # vars_[j] != 0 but vars_[k] == 0: ratio is infinite — never a
                # merge; skip instead of dividing by zero
                continue
            if abs(vars_[j] - vars_[k]) / denom < merge_vars_thr:
                probs[j] += probs[k]
                probs[k] = 0.0
                active[k] = False
    return probs, vars_, active


def merge_components_device(prior: MixturePrior, merge_vars_thr) -> MixturePrior:
    """On-device merge with identical semantics to `merge_components`
    (reference: src/vamp.cpp:627-642), unrolled over the static component
    count (L <= ~10, so ~L^2/2 scalar selects).  Keeping the merge inside
    the jitted EM phase removes ~6 host round trips per iteration, each of
    which would drain the device queue.
    """
    probs, vars_, active = prior.probs, prior.vars, prior.active
    thr = jnp.asarray(merge_vars_thr, dtype=jnp.float64)
    L = probs.shape[0]
    for j in range(L):
        for k in range(j + 1, L):
            denom = jnp.where(
                vars_[j] != 0.0, jnp.minimum(vars_[j], vars_[k]), 1e-7
            )
            # denom == 0 (vars_[j] != 0, vars_[k] == 0) means an infinite
            # ratio — never a merge; divide by a dummy 1.0 to keep the
            # masked-out lane finite (same host-side semantics)
            ratio = jnp.abs(vars_[j] - vars_[k]) / jnp.where(denom != 0.0, denom, 1.0)
            do = active[j] & active[k] & (denom != 0.0) & (ratio < thr)
            probs = probs.at[j].add(jnp.where(do, probs[k], 0.0))
            probs = probs.at[k].set(jnp.where(do, 0.0, probs[k]))
            active = active.at[k].set(jnp.where(do, False, active[k]))
    return MixturePrior(probs=probs, vars=vars_, active=active)


def init_prior(probs, vars_, n_samples: int, l_max: int | None = None) -> MixturePrior:
    """Build a MixturePrior from CLI-style probs/vars (unscaled); variances
    are scaled by N internally (reference: src/vamp.cpp:87-88)."""
    probs = np.asarray(probs, dtype=np.float64)
    vars_ = np.asarray(vars_, dtype=np.float64) * float(n_samples)
    L = len(probs)
    assert len(vars_) == L, "probs and vars must have equal length"
    l_max = l_max or L
    p = np.zeros(l_max)
    v = np.zeros(l_max)
    a = np.zeros(l_max, dtype=bool)
    p[:L] = probs
    v[:L] = vars_
    a[:L] = True
    return MixturePrior(
        probs=jnp.asarray(p), vars=jnp.asarray(v), active=jnp.asarray(a)
    )

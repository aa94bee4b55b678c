"""Pure-numpy float64 gVAMP oracle mirroring the reference algorithm
statement-for-statement (src/vamp.cpp), used to lock the JAX engine's
trajectories in tests.  Not a performance path.

This is an independent re-derivation from the algorithm (not a code copy):
list-based prior with true component erasure on merge, serial single-RHS CG,
explicit update order.
"""

from __future__ import annotations

import numpy as np


class NumpyVampOracle:
    def __init__(self, X, y, probs, vars_unscaled, *, gam1, h2, rho,
                 cg_max_iter=500, cg_err_tol=1e-5, em_max_iter=1,
                 em_err_thr=1e-2, learn_vars=1, learn_prior_delay=1,
                 merge_vars_thr=0.5, stop_criteria_thr=0.01,
                 em_h2_budget=0.0):
        self.N, self.M = X.shape
        self.X = np.asarray(X, dtype=np.float64)  # sample-major (N, M)
        self.y = np.asarray(y, dtype=np.float64)
        self.mave = self.X.mean(axis=0)
        sd = np.sqrt(((self.X - self.mave) ** 2).sum(axis=0) / (self.N - 1))
        self.msig = 1.0 / sd
        self.probs = list(map(float, probs))
        self.vars = [float(v) * self.N for v in vars_unscaled]
        self.gam1 = float(gam1)
        self.gamw = 1.0 / (1.0 - h2)
        self.rho = rho
        self.cg_max_iter = cg_max_iter
        self.cg_err_tol = cg_err_tol
        self.em_max_iter = em_max_iter
        self.em_err_thr = em_err_thr
        self.learn_vars = learn_vars
        self.learn_prior_delay = learn_prior_delay
        self.merge_vars_thr = merge_vars_thr
        self.stop_criteria_thr = stop_criteria_thr
        self.em_h2_budget = em_h2_budget  # engine: RunConfig.em_h2_budget
        self.gamma_min, self.gamma_max = 1e-11, 1e11

    # --- operator ---
    def Ax(self, x):
        w = self.msig * x
        return (self.X @ w - np.dot(self.mave, w)) / np.sqrt(self.N)

    def ATx(self, z):
        return self.msig * (self.X.T @ z - self.mave * z.sum()) / np.sqrt(self.N)

    def Q(self, v, tau, gam2):
        return tau * self.ATx(self.Ax(v)) + gam2 * v

    # --- denoisers ---
    def g1(self, y):
        sigma = 1.0 / self.gam1
        if abs(sigma) < 1e-10:
            return y.copy()
        eta_max = max(self.vars)
        pk = np.zeros_like(y)
        pkd = np.zeros_like(y)
        for p, v in zip(self.probs, self.vars):
            e = np.exp(-0.5 * y**2 * (eta_max - v) / (v + sigma) / (eta_max + sigma))
            z = p / np.sqrt(v + sigma) * e
            pk += z
            pkd -= z / (v + sigma) * y
        return y + sigma * pkd / pk

    def g1d(self, y):
        sigma = 1.0 / self.gam1
        if abs(sigma) < 1e-10:
            return np.ones_like(y)
        eta_max = max(self.vars)
        pk = np.zeros_like(y)
        pkd = np.zeros_like(y)
        pkdd = np.zeros_like(y)
        for p, v in zip(self.probs, self.vars):
            e = np.exp(-0.5 * y**2 * (eta_max - v) / (v + sigma) / (eta_max + sigma))
            z = p / np.sqrt(v + sigma) * e
            pk += z
            z2 = z / (v + sigma) * y
            pkd -= z2
            pkdd += -p / (v + sigma) ** 1.5 * e + z2 / (v + sigma) * y
        return 1.0 + sigma * (pkdd / pk - (pkd / pk) ** 2)

    # --- EM prior update + merge ---
    def update_prior(self, r1):
        noise_var = 1.0 / self.gam1
        lam = 1.0 - self.probs[0]
        L = len(self.probs)
        omegas = list(self.probs)
        for j in range(1, L):
            omegas[j] /= lam

        for _ in range(self.em_max_iter):
            max_sigma = max(self.vars)
            probs_prev = list(self.probs)
            vars_prev = list(self.vars)

            num = np.zeros((len(r1), L - 1))
            gmean = np.zeros((len(r1), L - 1))
            for j in range(1, L):
                v = self.vars[j]
                num[:, j - 1] = (
                    lam * omegas[j]
                    * np.exp(-r1**2 / 2 * (max_sigma - v) / (v + noise_var) / (max_sigma + noise_var))
                    / np.sqrt(v + noise_var) / np.sqrt(2 * np.pi)
                )
                gmean[:, j - 1] = self.gam1 * r1 / (1.0 / v + self.gam1)
            s = num.sum(axis=1)
            beta = num / s[:, None]
            pin = 1.0 / (
                1.0 + (1 - lam) / np.sqrt(2 * np.pi * noise_var)
                * np.exp(-r1**2 / 2 * max_sigma / noise_var / (noise_var + max_sigma)) / s
            )
            vpost = np.array([1.0 / (1.0 / self.vars[j] + self.gam1) for j in range(1, L)])
            lam_total = pin.sum()
            lam = lam_total / self.M
            gammas = beta * (gmean**2 + vpost[None, :])
            res = (beta * pin[:, None]).sum(axis=0)
            res_gammas = (gammas * pin[:, None]).sum(axis=0)
            for j in range(1, L):
                if self.learn_vars:
                    self.vars[j] = res_gammas[j - 1] / res[j - 1]
                omegas[j] = res[j - 1] / lam_total
                self.probs[j] = lam * omegas[j]
            self.probs[0] = 1.0 - lam

            dp = np.sqrt(
                sum((a - b) ** 2 for a, b in zip(self.probs, probs_prev))
                / sum(a * a for a in self.probs)
            )
            dv = np.sqrt(
                sum((a - b) ** 2 for a, b in zip(self.vars, vars_prev))
                / sum(a * a for a in self.vars)
            )
            if dp < self.em_err_thr and dv < self.em_err_thr:
                break

        # merge close variances (erasure semantics)
        j = 0
        while j < len(self.vars):
            k = j + 1
            while k < len(self.vars):
                denom = min(self.vars[j], self.vars[k]) if self.vars[j] != 0 else 1e-7
                if abs(self.vars[j] - self.vars[k]) / denom < self.merge_vars_thr:
                    self.probs[j] += self.probs[k]
                    del self.probs[k]
                    del self.vars[k]
                else:
                    k += 1
            j += 1

        # truth-free signal-budget projection (engine/linear.py _em_phase):
        # Var(y)=1 bounds the slab total M*lam*vbar (internal scale) by
        # N*em_h2_budget; scaling the slab vars back removes the wide-M/N
        # EM runaway.  0 = off (reference parity).
        if self.em_h2_budget > 0:
            total = self.M * sum(
                p * v for p, v in zip(self.probs[1:], self.vars[1:]))
            budget = self.N * self.em_h2_budget
            if total > budget:
                s = budget / total
                for j in range(1, len(self.vars)):
                    self.vars[j] *= s

    # --- CG ---
    def cg(self, v, mu_start, tau, gam2, denoiser):
        diag = tau * (self.N - 1) / self.N + gam2
        mu = mu_start.copy()
        r = v - self.Q(mu, tau, gam2)
        z = r / diag
        p = z.copy()
        prev_ons = 0.0
        norm_v = np.sqrt(np.dot(v, v))
        for _ in range(self.cg_max_iter):
            d = self.Q(p, tau, gam2)
            rz = np.dot(r, z)
            alpha = rz / np.dot(d, p)
            mu += alpha * p
            if denoiser == 0:
                ons = gam2 * np.dot(v, mu)
                rel = abs((ons - prev_ons) / ons) if ons != 0 else 1.0
                if rel < 1e-8:
                    break
                prev_ons = ons
            r -= alpha * d
            z = r / diag
            beta = np.dot(r, z) / rz
            p = z + beta * p
            if np.sqrt(np.dot(r, r)) / norm_v < self.cg_err_tol:
                break
        return mu

    # --- full iteration loop ---
    def run(self, max_iter, probes, x1hat_init=None):
        """probes: list of (M,) Rademacher/sqrt(M) probe vectors, one per
        iteration (injected so tests can share them with the JAX engine)."""
        M, N = self.M, self.N
        sqrtN = np.sqrt(N)
        init = (np.asarray(x1hat_init) / sqrtN) if x1hat_init is not None else np.zeros(M)
        x1_hat = init.copy()
        r1 = init.copy()
        mu_warm = np.zeros(M)
        gam2 = 0.0
        history = []

        for it in range(1, max_iter + 1):
            if it > self.learn_prior_delay:
                self.update_prior(r1)
            x1_prev = x1_hat.copy()
            x1_hat = self.g1(r1)
            if it > 1:
                x1_hat = self.rho * x1_hat + (1 - self.rho) * x1_prev
            alpha1 = self.g1d(r1).sum() / M
            eta1 = self.gam1 / alpha1
            gam2 = np.clip(eta1 - self.gam1, self.gamma_min, self.gamma_max)
            r2 = (eta1 * x1_hat - self.gam1 * r1) / gam2

            bern = probes[it - 1]
            v = self.gamw * self.ATx(self.y) + gam2 * r2
            x2_hat = self.cg(v, mu_warm, self.gamw, gam2, denoiser=1)
            mu_warm = x2_hat.copy()
            invq = self.cg(bern, np.zeros(M), self.gamw, gam2, denoiser=0)
            alpha2 = gam2 * np.dot(bern, invq)
            eta2 = gam2 / alpha2
            gam1_prev = self.gam1
            g1n = np.clip(eta2 - gam2, self.gamma_min, self.gamma_max)
            self.gam1 = self.rho * g1n + (1 - self.rho) * gam1_prev
            r1 = (eta2 * x2_hat - gam2 * r2) / self.gam1

            resid = self.Ax(x2_hat) - self.y
            trace_corr = np.dot(bern, self.ATx(self.Ax(invq))) * M
            self.gamw = N / (np.dot(resid, resid) + trace_corr)

            history.append(
                dict(it=it, alpha1=alpha1, gam1_pre=gam1_prev, gam2=gam2,
                     alpha2=alpha2, gam1=self.gam1, gamw=self.gamw,
                     x1_hat=x1_hat.copy(), r1=r1.copy(), x2_hat=x2_hat.copy(),
                     probs=list(self.probs), vars=list(self.vars))
            )

            diff = x1_hat - x1_prev
            denom = np.dot(x1_prev, x1_prev)
            if denom > 0:
                nmse = np.sqrt(np.dot(diff, diff) / denom)
                if it > 1 and nmse < self.stop_criteria_thr:
                    break
        return history


def engine_probes(seed, n_iter, m_pad, mt):
    """The engine's seeded Rademacher trace probes (engine/linear.py CG
    path), regenerated for the oracle.  threefry bits are the same on every
    backend, so this matches the engine on the CPU and on a GPU alike."""
    import jax
    import jax.numpy as jnp

    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(n_iter):
        key, sub = jax.random.split(key)
        b = jax.random.rademacher(sub, (m_pad,), dtype=jnp.float64) / np.sqrt(float(mt))
        out.append(np.asarray(b))
    return out

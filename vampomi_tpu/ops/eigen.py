"""Eigen-LMMSE: once-per-dataset spectral decomposition of the Gram matrix.

The Gram matrix K = A A^T is FIXED for the whole run — only the scalar
shift pair (tau, gam2) of the dual matrix S = gam2 I + tau K moves between
VAMP iterations.  The spectral path (ops/spectral.py) refactors S every
iteration: ~2N^3/3 FLOPs, replicated on every device of a mesh — the
Amdahl term that caps multi-device scaling (SCALING.md).

This module instead diagonalizes K ONCE:

    K = U diag(lam) U^T          (U orthonormal, built from matmuls)

after which EVERY per-iteration dense quantity is O(N^2) or closed-form:

    S^{-1} b      = U ((gam2 + tau*lam)^{-1} ∘ (U^T b))   [2 N^2 matvecs]
    tr(S^{-1})    = sum_i 1/(gam2 + tau*lam_i)            [exact, f64]
    tr(Q^{-1}), tr(A^T A Q^{-1}) via the same counting identities as
    ops/spectral.py `_trace_closed_forms`.

On a multi-device mesh U's columns are sharded over the marker axis, so the
per-iteration dense work scales ~1/C (one extra psum of an N-vector) — the
factor path cannot be sharded this way and replicates (SCALING.md).

Why not jnp.linalg.eigh: this eigensolver predates the GPU port, when the
accelerator's own eigh was unusable at these sizes; whether cuSOLVER's eigh
now replaces it is an open question (chip_smoke.py times both).  Why not host
LAPACK: dsyevd at N=10240 takes minutes on one host core.  The solver
here is an algorithm made of large matmuls:

  1. A stochastic Lanczos quadrature pass (batched matvec steps through
     ONE jitted kernel, no reorthogonalization) bounds the spectral range;
     split points are each block's exact trace-mean — self-balancing for
     bulk spectra, self-correcting for outlier-heavy ones;
  2. sign-function divide and conquer: for a split sigma, the matrix sign
     of (sigma I - K)/alpha is computed by a scaled Newton-Schulz cubic
     iteration (2 matmuls per step; the cubic p(x) = a x - b x^3 is chosen
     per-step in closed form so the lower spectral bound grows ~2.6x per
     iteration instead of plain NS's 1.5x), giving spectral projectors
     P = (I ± sign)/2;
  3. blocked randomized Gram-Schmidt extracts an orthonormal basis of each
     projector's range (fixed-width slabs through device CholQR2, fused
     into one dispatch each; the rank-critical final slab through a
     rank-safe host eigh-of-Gram, ~1 MB fetch); K is compressed and the
     recursion continues until blocks reach `leaf` real dimensions, which
     a host f64 eigh finishes (~2.5 s at the default leaf=2048).

Measured at N=8192 (M=262144 bf16 Gram, MP bulk): Rayleigh residual
1.1e-6, orthogonality 1.5e-6, solve/trace agreement with the factor path
1e-6 / 1e-11.  Wall time is dominated by compiles and dispatch, not
FLOPs.

Numerical posture: all matmuls run at HIGHEST (full-f32) precision — the
same load-bearing choice as ops/spectral.py (reduced-precision operands,
bf16 or TF32, are unsafe there).  Eigenvector error concentrates between
NEIGHBORING eigenvalues (tiny spectral gaps), which is benign for every
quantity consumed here: mixing between close eigenvalues perturbs
U f(lam) U^T only at second order because f is smooth.  The final factor
always carries a measured Rayleigh residual ||K U - U lam||_F / ||K||_F;
the engine falls back to the per-iteration factor path when it exceeds
tolerance.

Reference mapping: replaces the per-iteration CG solves + Hutchinson
probes of src/vamp.cpp:494-529 and 645-757 (like ops/spectral.py) but with
an amortized dense build instead of a per-iteration one.
"""

from __future__ import annotations

import functools
import math
import sys
import time
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .operator import DesignMatrix, atx, ax
from .spectral import GramFactor, _trace_closed_forms


class EigenBuildTimeout(RuntimeError):
    """Raised by build_eigen when a caller-supplied wall-clock deadline
    expires mid-build.  The build is abandoned cleanly between device
    steps; callers fall back to the per-iteration factor path (the bench
    and the engine both treat this as 'use spectral')."""


class EigenFactor(NamedTuple):
    """The reusable eigen-LMMSE state.

    U   : (N, N) orthonormal eigenvectors of K (columns, ascending lam),
          work dtype; columns sharded over the marker mesh axis when built
          on a multi-device mesh, replicated otherwise.
    lam : (N,) f64 Rayleigh eigenvalues diag(U^T K U) — exact for the
          subspaces actually used, so the per-iteration traces are exact
          closed forms at working precision.
    """

    U: jax.Array
    lam: jax.Array

    @property
    def n(self) -> int:
        return self.U.shape[0]


# --------------------------------------------------------------------------
# device helpers.  EVERYTHING that touches device data is a fixed-shape jit:
# each new (op, shape) pair is a compile and each eager op a dispatch, so
# the host-driven recursion keeps a small closed set of jitted kernels
# whose shapes are quantized across the whole tree (see build_eigen
# docstring) — ~60 compiles where eager glue needed ~1500.
# --------------------------------------------------------------------------


def _hp():
    return jax.default_matmul_precision("highest")


def _i32(i) -> jax.Array:
    """Strong-typed int32 index scalar: one aval (and one compile) for
    every index value, weak-typed or not."""
    return jnp.asarray(i, jnp.int32)


def _quant(r: int) -> int:
    """Width quantum for basis buffers at parent block size r.  2048 above
    2048 (was 1024 in round 3): halving the number of distinct block widths
    quadratically shrinks the (r, kq) compile-shape lattice — the dominant
    cold-build cost — at the price of more zero padding, which costs only
    matmul time."""
    if r >= 2048:
        return 2048
    return 1024 if r >= 1024 else 64


# Upad column slack past n: a final leaf can overhang by up to
# quant - 1 + slab slack (< _quant + 1416), so 4096 covers quant = 2048.
U_TAIL = 4096


@functools.partial(jax.jit, static_argnames=("shape", "dtype"))
def _gauss_jit(key, shape, dtype):
    """jitted standard-normal block: one named compile-cache entry per
    (shape, dtype) instead of the eager path's internal jits."""
    return jax.random.normal(key, shape, dtype=dtype)


@functools.partial(jax.jit, static_argnames=("shape", "dtype"))
def _zeros_jit(shape, dtype):
    return jnp.zeros(shape, dtype=dtype)


@jax.jit
def _reorder_jit(Upad, order):
    """Final (n, n + U_TAIL) -> (n, n) gather: reorder by eigenvalue and
    drop the buffer tail in one fixed-shape dispatch."""
    return jnp.take(Upad, order, axis=1)


@jax.jit
def _trace_jit(Kb):
    return jnp.trace(Kb)


@jax.jit
def _fingerprint_jit(K):
    """Dataset fingerprint for the eigen cache: trace plus the first 8
    entries of K z for a fixed random probe z.  The trace alone is NOT
    discriminating (any two same-shape standardized Grams have trace ~ N);
    the probe sketch differs at O(1) relative scale between datasets while
    being bit-reproducible for the same K on the same platform."""
    n = K.shape[0]
    z = jax.random.normal(jax.random.PRNGKey(987654321), (n,), dtype=K.dtype)
    s = K @ z
    return jnp.concatenate([jnp.trace(K)[None], s[:8]])


@jax.jit
def _sign_init(Kb, dvec, inv_alpha):
    """X0 = (diag(dvec) - Kb) * inv_alpha with dvec = sigma - padvec: the
    scaled sign-iteration seed, pads already shifted above the window."""
    return (jnp.diag(dvec) - Kb) * inv_alpha


@jax.jit
def _ns_step(X, a, b):
    """One scaled Newton-Schulz sign step  X <- a X - b X^3  plus the
    convergence diagnostic max|diag(X^2) - 1| of the INPUT X (X symmetric)."""
    with _hp():
        X2 = X @ X
        Xn = a * X - b * (X @ X2)
    d = jnp.sum(X * X, axis=1)
    return Xn, jnp.max(jnp.abs(d - 1.0))


@jax.jit
def _sign_finish(X, rmask):
    """Symmetrize the converged sign, form both spectral projectors, the
    sign trace, and ||X||_F^2 in one dispatch.  rmask is 1 on real
    coordinates, 0 on pads: the high-side projector P2 is masked exactly
    (the sign of the block-diagonal padded matrix is block-diagonal, so
    zeroing pad rows+cols removes exactly the pad directions).

    ||X||_F^2 = sum of squared sign eigenvalues counts CONVERGED modes
    (each contributes ~1); r - ||X||_F^2 therefore counts the modes stuck
    at ~0 — eigenvalues sitting essentially ON sigma.  A degenerate
    CLUSTER at sigma leaves the trace integer (the zero modes contribute
    0), so the trace test alone cannot see it, yet both children would
    then extract independent random subspaces of the cluster's eigenspace
    that overlap instead of complementing — the caller must nudge sigma."""
    Xs = 0.5 * (X + X.T)
    r = X.shape[0]
    eye_half = 0.5 * jnp.eye(r, dtype=X.dtype)
    P1 = eye_half + 0.5 * Xs
    P2 = (eye_half - 0.5 * Xs) * rmask[:, None] * rmask[None, :]
    return P1, P2, jnp.trace(Xs), jnp.sum(Xs * Xs)


@jax.jit
def _compress(Kb, Ub, Q):
    """Child block K1 = Q^T Kb Q (symmetrized) and accumulated basis
    U1 = Ub Q, one dispatch.  Q's trailing columns are exactly zero, so the
    child arrives pre-padded (zero rows/cols past the real rank)."""
    with _hp():
        KQ = Kb @ Q
        K1 = Q.T @ KQ
        U1 = Ub @ Q
    return 0.5 * (K1 + K1.T), U1


@jax.jit
def _compress_root(Kb, Q):
    """_compress for the root node (accumulated basis is Q itself)."""
    with _hp():
        KQ = Kb @ Q
        K1 = Q.T @ KQ
    return 0.5 * (K1 + K1.T), Q


@jax.jit
def _project_slab(P, Qacc, G):
    """Y = (I - Qacc Qacc^T) P G — project a slab into range(P) and
    orthogonalize against the accumulated basis (zero columns inert)."""
    with _hp():
        Y = P @ G
        Y = Y - Qacc @ (Qacc.T @ Y)
    return Y


@jax.jit
def _gram_jit(Y):
    with _hp():
        return Y.T @ Y


@jax.jit
def _mix_jit(Y, T):
    with _hp():
        return Y @ T


@jax.jit
def _slab_write(Qacc, Qc, off):
    return jax.lax.dynamic_update_slice(Qacc, Qc, (jnp.int32(0), off))


@jax.jit
def _leaf_mix(Ub, Vp):
    with _hp():
        return Ub @ Vp


@jax.jit
def _leaf_write(Uacc, cols, off, nreal):
    """Write the first `nreal` columns of `cols` into Uacc at column `off`,
    leaving every other column of Uacc untouched.  off/nreal are traced
    scalars, so the compile-cache key is only (Uacc.shape, cols.shape) —
    both quantized — unlike a cols[:, :r_real] slice whose shape would be a
    fresh compile for every distinct leaf width (and a
    persistent-cache MISS across datasets, since leaf widths depend on the
    spectrum)."""
    cur = jax.lax.dynamic_slice(Uacc, (jnp.int32(0), off), cols.shape)
    keep = jnp.arange(cols.shape[1]) < nreal
    merged = jnp.where(keep[None, :], cols, cur)
    return jax.lax.dynamic_update_slice(Uacc, merged, (jnp.int32(0), off))


@jax.jit
def _rayleigh_jit(K, U):
    """Rayleigh values diag(U^T K U), the residual ||KU - U lam||/||K||,
    and max|U^T U - I|, fused into one dispatch."""
    with _hp():
        KU = K @ U
        lam_r = jnp.einsum("ni,ni->i", U, KU)
        resid = jnp.linalg.norm(KU - U * lam_r[None, :]) / jnp.linalg.norm(K)
        G = U.T @ U
    n = K.shape[0]
    ortho = jnp.max(jnp.abs(G - jnp.eye(n, dtype=K.dtype)))
    return lam_r, resid, ortho


def _ns_coeffs(ell: float) -> tuple[float, float, float]:
    """Closed-form equioscillating cubic for the sign iteration.

    For spectrum magnitude in [ell, 1], p(x) = a x - b x^3 with
        xp = sqrt((1 + ell + ell^2) / 3),  a = 3 / (2 xp),  b = a / (1 + ell + ell^2)
    maps [ell, 1] into [ell', 1] with the peak exactly 1 and
    p(ell) = p(1) = ell' = a ell - b ell^3 — the growth factor approaches
    2.6x/step for small ell and reduces to plain Newton-Schulz
    (a, b) = (1.5, 0.5) at ell = 1.  p has its zero at sqrt(1+ell+ell^2)
    > 1.0005, so a 10% over-estimate of the scale alpha keeps every
    eigenvalue strictly inside the sign-preserving region.
    """
    s = 1.0 + ell + ell * ell
    xp = math.sqrt(s / 3.0)
    a = 1.5 / xp
    b = a / s
    ell_new = a * ell - b * ell**3
    return a, b, min(ell_new, 1.0)


def _check_deadline(deadline):
    if deadline is not None and time.time() > deadline:
        raise EigenBuildTimeout(
            f"eigen build exceeded its wall-clock deadline "
            f"({time.strftime('%H:%M:%S')})")


def _matrix_sign(Kb, dvec, alpha, ell0, max_iter=40, tol=None, deadline=None):
    """sign((diag(dvec + ...) - Kb)/alpha) by the scaled NS cubic, where
    dvec = sigma - padvec folds the split point and the pad shift into one
    diagonal (see build_eigen).  Returns the UNSYMMETRIZED iterate; the
    caller finishes with _sign_finish.

    ell0 is a conservative guess of the smallest |eigenvalue| after
    scaling; if the true gap at sigma is smaller, the tracked bound is
    optimistic and the post-loop plain-NS polish (convergence-checked via
    diag(X^2)) finishes the job.  Unconverged modes sit exactly at the
    split and are benign (see module docstring).
    """
    wd = Kb.dtype
    if tol is None:
        tol = 3e-4 if wd == jnp.float32 else 1e-10
    X = _sign_init(Kb, dvec, jnp.asarray(1.0 / alpha, dtype=wd))
    ell = ell0
    it = 0
    while ell < 0.92 and it < max_iter:
        a, b, ell = _ns_coeffs(ell)
        X, _ = _ns_step(X, jnp.asarray(a, wd), jnp.asarray(b, wd))
        it += 1
    # polish with plain NS, TWO steps per convergence fetch: each scalar
    # fetch is a host round trip that drains the device queue, while an
    # extra (possibly unneeded) NS step is two matmuls — and a converged
    # sign is a fixed point of the iteration, so overshooting is exact,
    # not just harmless
    while it < max_iter:
        _check_deadline(deadline)
        X, _ = _ns_step(X, jnp.asarray(1.5, wd), jnp.asarray(0.5, wd))
        it += 1
        if it >= max_iter:
            break
        X, errd = _ns_step(X, jnp.asarray(1.5, wd), jnp.asarray(0.5, wd))
        it += 1
        if float(errd) < tol:
            break
    return X


def _orth_small_fixed(Y, k, passes=2, valid=None):
    """Orthonormal rank-k basis of Y's dominant range via host f64 eigh of
    the small Gram (rank-deficiency-safe where CholQR is not).

    Fixed-shape formulation: Y keeps its full slab width cw through every
    pass (valid data in the first `valid` columns, exact zeros beyond).
    The eigh runs on the HOST-SLICED (valid, valid) Gram block — the exact
    zero columns beyond `valid` would otherwise contribute eigenvalue-0
    pad eigenpairs that can sort ABOVE a tiny-negative (f32-noise) real
    eigenvalue and get 1/sqrt(1e-300) scalings that overflow to inf.
    Returns (r, cw) with the orthonormal basis in the FIRST k columns and
    exact zeros beyond, so downstream matmuls keep one compile-cache shape.
    The full-width Gram fetch is ~3.7 MB at cw = 968."""
    cw = Y.shape[1]
    if valid is None:
        valid = cw
    for _ in range(passes):
        G = _gram_jit(Y)
        Gh = np.asarray(jax.device_get(G), dtype=np.float64)[:valid, :valid]
        Gh = 0.5 * (Gh + Gh.T)
        ev, V = np.linalg.eigh(Gh)
        T = np.zeros((cw, cw))
        T[:valid, :k] = V[:, -k:] / np.sqrt(np.maximum(ev[-k:], 1e-300))
        Y = _mix_jit(Y, jnp.asarray(T, dtype=Y.dtype))
        valid = k
    return Y


def _cholqr2(Y):
    """Device CholQR, twice (CholQR2: the second pass restores full f32
    orthogonality).  Valid only for well-conditioned Y — callers keep the
    chunk width well below the remaining rank so the random-projection
    Gram stays far from singular."""
    for _ in range(2):
        with _hp():
            G = Y.T @ Y
        c = G.shape[0]
        ridge = 1e-7 * jnp.trace(G) / c
        R = jnp.linalg.cholesky(G + ridge * jnp.eye(c, dtype=G.dtype))
        Rinv = jax.scipy.linalg.solve_triangular(
            R, jnp.eye(c, dtype=G.dtype), lower=True
        )
        with _hp():
            Y = Y @ Rinv.T
    return Y


@jax.jit
def _subspace_chunk(P, Qacc, G, off):
    """One full-width randomized Gram-Schmidt slab, fused into a single
    dispatch (the eager formulation cost ~18 host round trips per chunk):
    project a fresh random block into range(P), orthogonalize against the
    accumulated basis (zero columns in Qacc are inert), CholQR2, re-project
    to tighten the range, CholQR2 again, and write the slab into Qacc at
    column `off` (traced — one compile per (r, k_quantized) shape pair)."""
    with _hp():
        Y = P @ G
        Y = Y - Qacc @ (Qacc.T @ Y)
        Y = _cholqr2(Y)
        Y2 = P @ Y
        Y2 = Y2 - Qacc @ (Qacc.T @ Y2)
        Q = _cholqr2(Y2)
    return jax.lax.dynamic_update_slice(Qacc, Q, (jnp.int32(0), off))


_CHUNK = 448  # device-CholQR chunk width (host finishes the last <=512)


def _orth_range(P, k, key):
    """Orthonormal rank-k basis of the range of the (approximate)
    projector P, by blocked randomized Gram-Schmidt.

    Full-width randomized CholQR is ill-conditioned when the sample count
    equals the rank (square Gaussian Wishart), and a host eigh of a k x k
    Gram at k ~ N/2 is a large host transfer and a slow host solve — so the basis is
    built in _CHUNK-wide slabs (each slab's random projection into the
    REMAINING range is a fat rectangular Gaussian — well-conditioned for
    device CholQR2), with the final <=960 columns finished by the
    rank-safe host eigh-of-Gram path over a FIXED 968-wide sample slab.

    Returns (Qacc, kq): the FULL quantized-width (r, kq) buffer with the
    basis in the first k columns and exact zeros beyond.  Handing the
    quantized buffer (not a [:, :k] slice) to _compress keeps every big
    matmul in the tree on one of ~N/1024 compile-cache shapes, and makes
    the child block arrive pre-padded (kq - k zero rows/cols)."""
    r = P.shape[0]
    cw = min(2 * 512 - 56, r)  # fixed sample/slab width for this r
    quant = _quant(r)
    # minimal buffer width: the final cw-wide slab is written at the exact
    # offset the chunk loop reaches (_CHUNK * n_chunks), so kq stays within
    # one quant step of k even for degenerate splits (k ~ r), instead of
    # the k + cw worst case that let children outgrow their parent
    if k <= 2 * 512 - 64:
        need = max(k, cw)
    else:
        n_chunks = -(-(k - (2 * 512 - 64)) // _CHUNK)
        need = _CHUNK * n_chunks + cw
    kq = ((need + quant - 1) // quant) * quant
    Qacc = _zeros_jit(shape=(r, kq), dtype=P.dtype)
    done = 0
    while done < k:
        rest = k - done
        if rest <= 2 * 512 - 64:
            # final slab, host-side rank-safe orthonormalization; every
            # device op has the fixed shape (r, cw)
            G = _gauss_jit(key, shape=(r, cw), dtype=P.dtype)
            key, = jax.random.split(key, 1)
            Y = _project_slab(P, Qacc, G)
            Qc = _orth_small_fixed(Y, rest, passes=2)
            # one subspace-iteration polish tightens the range accuracy
            # (Qc's zero tail columns pass through the projection as zeros)
            Y2 = _project_slab(P, Qacc, Qc)
            Qc = _orth_small_fixed(Y2, rest, passes=1, valid=rest)
            Qacc = _slab_write(Qacc, Qc, _i32(done))
            done = k
        else:
            # full-width device slab: ALWAYS _CHUNK columns (fixed shapes),
            # one fused dispatch
            G = _gauss_jit(key, shape=(r, _CHUNK), dtype=P.dtype)
            key, = jax.random.split(key, 1)
            Qacc = _subspace_chunk(P, Qacc, G, _i32(done))
            done += _CHUNK
    return Qacc, kq


@jax.jit
def _slq_norm(V):
    return V / jnp.linalg.norm(V, axis=0)


@jax.jit
def _lanczos_step(Kk, Vc, Vp, beta):
    """One no-reorth batched Lanczos step (fixed shapes; jitted ONCE and
    driven from the host — a lax.scan formulation compiled far slower).
    Breakdown (beta == 0) freezes that probe; the host truncates its
    quadrature at the first zero beta."""
    with _hp():
        W = Kk @ Vc
    W = W - beta * Vp
    alph = jnp.sum(Vc * W, axis=0)
    W = W - alph * Vc
    beta_n = jnp.linalg.norm(W, axis=0)
    Vn = jnp.where(beta_n > 0, W / jnp.where(beta_n > 0, beta_n, 1.0), Vc)
    return Vn, alph, beta_n


def _slq_bounds(K, probes=8, steps=64, seed=0):
    """Spectral-range estimate [lo, hi] by stochastic Lanczos quadrature.

    Lanczos converges the EXTREME eigenvalues fast even without
    reorthogonalization, so the pooled Ritz extremes bound the true range
    to well under the 20% safety margin applied by the caller."""
    n = K.shape[0]
    wd = K.dtype
    steps = min(steps, n)
    key = jax.random.PRNGKey(seed)
    V = _gauss_jit(key, shape=(n, probes), dtype=wd)
    V = _slq_norm(V)
    Vp = _zeros_jit(shape=(n, probes), dtype=wd)
    beta = _zeros_jit(shape=(probes,), dtype=wd)
    alphas, betas = [], []
    for _ in range(steps):
        Vn, alph, beta_n = _lanczos_step(K, V, Vp, beta)
        alphas.append(alph)
        betas.append(beta_n)
        Vp, V, beta = V, Vn, beta_n
    # device_get on the LISTS fetches every step in one call with no
    # 64-operand stack compile (jnp.stack here was its own compile)
    A = np.asarray(np.stack(jax.device_get(alphas)), dtype=np.float64)
    B = np.asarray(np.stack(jax.device_get(betas)), dtype=np.float64)

    import scipy.linalg as sla

    ritz_min, ritz_max = np.inf, -np.inf
    for p in range(probes):
        a, b = A[:, p], B[:-1, p]
        m = steps
        nz = np.nonzero(b <= 0)[0]
        if len(nz):
            m = int(nz[0]) + 1
        w = sla.eigh_tridiagonal(a[:m], b[: m - 1], eigvals_only=True)
        ritz_min = min(ritz_min, float(w[0]))
        ritz_max = max(ritz_max, float(w[-1]))
    return ritz_min, ritz_max


def _host_leaf_eigh(Kb, r_real):
    """Host f64 eigh of the REAL part of a leaf block.  The pad tail is
    sliced off HOST-side after the fetch — a device Kb[:r_real, :r_real]
    would compile per distinct (r, r_real) pair."""
    Kh = np.asarray(jax.device_get(Kb), dtype=np.float64)[:r_real, :r_real]
    Kh = 0.5 * (Kh + Kh.T)
    lam, V = np.linalg.eigh(Kh)
    return lam, V


def build_eigen(
    fac: GramFactor,
    seed: int = 0,
    leaf: int = 2048,
    max_depth: int = 60,
    verbose: bool = False,
    deadline: float | None = None,
) -> tuple[EigenFactor, dict]:
    """Diagonalize K = fac.K.  Returns (EigenFactor, diagnostics) with
    diagnostics = {"resid": Rayleigh residual, "ortho": max |U^T U - I|,
    "splits": #sign splits, "leaves": #host leaves}.

    Host-driven recursion over device blocks; all large compute is
    matmuls at HIGHEST precision.  Deterministic for a given (K, seed) —
    safe to run identically on every process of a multi-host program.

    Three choices here bound the number of compiles (each new op shape is
    a compile):

    * split points are the block's exact trace-mean (one scalar fetch) —
      self-balancing and free — instead of estimated spectral medians;
    * every child block arrives PADDED up to a quantized width (the
      compression runs over the full zero-tailed basis buffer from
      _orth_range); pads carry a far-above-the-spectrum diagonal only
      inside each sign call (pad directions are exact eigenpairs of the
      padded block and their accumulated-U columns are exactly zero), so
      block dimensions take ~N/1024 distinct values and the big-matmul
      compile cache hits across the whole tree and across runs;
    * every per-node step (sign seed, projectors, compression, slab
      projection, leaf mixing) is ONE fused fixed-shape jit — an eager
      formulation needed ~1500 tiny-op compiles and as many dispatches.
    """
    K = fac.K
    n = fac.n
    wd = K.dtype

    def vlog(msg):
        if verbose:
            print(f"eigen[{time.time() - t_start:7.1f}s] {msg}",
                  file=sys.stderr, flush=True)

    t_start = time.time()
    return _build_eigen_inner(
        fac, seed, leaf, max_depth, verbose, deadline, vlog, t_start)


def _build_eigen_inner(fac, seed, leaf, max_depth, verbose, deadline, vlog,
                       t_start):
    K = fac.K
    n = fac.n
    wd = K.dtype
    lo_r, hi_r = _slq_bounds(K, seed=seed)
    vlog(f"slq bounds done [{lo_r:.4g}, {hi_r:.4g}]")
    span = hi_r - lo_r if hi_r > lo_r else max(abs(hi_r), 1.0)
    lo0 = lo_r - 0.1 * span
    hi0 = hi_r + 0.1 * span

    key = jax.random.PRNGKey(seed + 1)
    # eigenvector accumulation buffer: leaves masked-write their real
    # columns at a running offset (_leaf_write), so no per-leaf-width slice
    # or final variable-width concatenate ever compiles.  The +U_TAIL tail
    # absorbs the largest possible pad overhang of a final leaf write
    # (quant - 1 + slab slack < 3464) without dynamic_update_slice clamping.
    Upad = _zeros_jit(shape=(n, n + U_TAIL), dtype=wd)
    u_off = 0
    out_lams: list[np.ndarray] = []
    stats = {"splits": 0, "leaves": 0}

    # INVARIANT: every block is exactly [real (r_real) ⊕ pad·I (trailing)].
    # Pads stay coordinate-aligned forever: sign of a block-diagonal matrix
    # is block-diagonal, so the real-side projectors can be masked exactly,
    # children arrive pre-padded from the quantized-basis compression, and
    # leaves slice the pad tail off without any eigenvalue thresholding.
    # The pad diagonal value is chosen PER SIGN CALL just above the block's
    # real window, so pads never inflate the sign scaling alpha.
    #
    # stack entries: (K_block, U_block | None, lo, hi, npad, depth, sigma0);
    # lo/hi bound the block's REAL spectrum; sigma0 overrides the trace-mean
    # split point after a one-sided retry (bisection).
    stack = [(K, None, lo0, hi0, 0, 0, None)]
    while stack:
        _check_deadline(deadline)
        Kb, Ub, lo, hi, npad, depth, sigma0 = stack.pop()
        r = Kb.shape[0]
        r_real = r - npad

        if r_real <= leaf or depth >= max_depth or (hi - lo) / span < 1e-8:
            lam, V = _host_leaf_eigh(Kb, r_real)
            # pad the mixing matrix host-side so the big Ub @ Vp matmul
            # keeps one compile-cache shape per r; the masked write drops
            # the pad columns without a per-r_real device slice
            Vp = np.zeros((r, r))
            Vp[:r_real, :r_real] = V
            if Ub is None:
                # root-as-leaf: npad == 0 and the basis is Vp itself
                cols = jnp.asarray(Vp, dtype=wd)
            else:
                cols = _leaf_mix(Ub, jnp.asarray(Vp, dtype=wd))
            Upad = _leaf_write(Upad, cols, _i32(u_off), _i32(r_real))
            u_off += r_real
            out_lams.append(lam)
            stats["leaves"] += 1
            vlog(f"leaf r={r} ({r_real} real) done")
            continue

        if sigma0 is not None:
            sigma = sigma0
        else:
            # exact trace-mean of the REAL spectrum (pads contribute zero to
            # the trace by construction): balanced for bulk spectra, and
            # self-correcting for outlier-heavy ones (outliers split off
            # fast, then the remainder re-splits at ITS own mean)
            sigma = float(_trace_jit(Kb)) / r_real
            sigma = min(max(sigma, lo + 1e-3 * (hi - lo)),
                        hi - 1e-3 * (hi - lo))
        # pads masquerade as real eigenvalues just above the window top
        pad_here = hi + 0.02 * (hi - lo)
        padvec = np.zeros(r)
        padvec[r_real:] = pad_here
        rmask_np = np.ones(r)
        rmask_np[r_real:] = 0.0
        rmask = jnp.asarray(rmask_np, dtype=wd)
        # non-integer sign trace means sigma sits essentially ON an
        # eigenvalue: nudge and redo (cost: one extra sign run)
        for attempt in range(3):
            # alpha/ell0 are recomputed INSIDE the retry loop: a nudged
            # sigma widens max|lam - sigma|, and a stale alpha would let
            # scaled eigenvalues cross the NS cubic's sign-preserving zero
            alpha = 1.1 * max(sigma - lo,
                              max(hi, pad_here if npad else hi) - sigma)
            # conservative first guess for the scaled gap at sigma: one
            # mean spacing of the block's real density
            ell0 = max(1e-7,
                       min(1e-2, (hi - lo) / (2.0 * alpha * max(r_real, 2))))
            dvec = jnp.asarray(sigma - padvec, dtype=wd)
            X = _matrix_sign(Kb, dvec, alpha, ell0, deadline=deadline)
            stats["splits"] += 1
            # P1: projector onto real eigs < sigma; P2: real eigs > sigma,
            # pads masked off exactly
            P1, P2, trXd, trsq = _sign_finish(X, rmask)
            # ONE fetch for both convergence scalars (each device_get is a
            # host round trip; this runs once per split)
            trX, trsq_h = map(float, jax.device_get((trXd, trsq)))
            # modes stuck at ~0 = eigenvalues ON sigma (see _sign_finish);
            # each retry costs one sign run, and after 3 the recursion
            # proceeds with the last split exactly as before
            n_zero = r - trsq_h
            if abs(trX - round(trX)) < 0.25 and n_zero < 0.5:
                break
            if attempt < 2:
                # nudge only when another attempt will run: the child
                # windows below must be derived from the sigma that
                # actually produced the projectors in use
                sigma = sigma + (0.04 * (attempt + 1)) * (hi - sigma)
                vlog(f"sign r={r} trace {trX:.2f} / {n_zero:.2f} modes on "
                     f"sigma — nudging")
        vlog(f"sign r={r} done (sigma={sigma:.4g}, trX={trX:.2f})")

        r1 = int(round(0.5 * (r + trX)))  # real eigs BELOW sigma
        if r1 <= 0 or r1 >= r_real:
            # every real eigenvalue on one side: bisect the window
            if r1 <= 0:
                lo = sigma
            else:
                hi = sigma
            stack.append((Kb, Ub, lo, hi, npad, depth + 1,
                          0.5 * (lo + hi)))
            continue

        key, k1, k2 = jax.random.split(key, 3)
        Q1, kq1 = _orth_range(P1, r1, k1)
        Q2, kq2 = _orth_range(P2, r_real - r1, k2)
        if Ub is None:
            K1, U1 = _compress_root(Kb, Q1)
            K2, U2 = _compress_root(Kb, Q2)
        else:
            K1, U1 = _compress(Kb, Ub, Q1)
            K2, U2 = _compress(Kb, Ub, Q2)
        margin = 0.05 * (hi - lo)
        stack.append((K1, U1, lo, sigma + margin,
                      kq1 - r1, depth + 1, None))
        stack.append((K2, U2, sigma - margin, hi,
                      kq2 - (r_real - r1), depth + 1, None))
        vlog(f"split r={r} -> {r1}+{r_real - r1} real (depth {depth})")

    lam_cat = np.concatenate(out_lams)
    if u_off != n or len(lam_cat) != n:
        raise RuntimeError(
            f"eigen build lost dimensions: {u_off} vs N={n} "
            f"(rank extraction failed at some split)"
        )
    order = np.argsort(lam_cat, kind="stable")
    U = _reorder_jit(Upad, jnp.asarray(order, dtype=np.int32))

    # Rayleigh refinement + residual diagnostics (one fused N^3 dispatch)
    lam_r, resid, orthod = _rayleigh_jit(K, U)
    ortho = float(orthod)
    lam64 = jnp.asarray(np.asarray(jax.device_get(lam_r), dtype=np.float64))

    U, lam64 = _shard_factor(U, lam64, K)
    diag = {"resid": float(resid), "ortho": ortho, **stats}
    return EigenFactor(U=U, lam=lam64), diag


def _shard_factor(U, lam64, K):
    """On a multi-device mesh, shard U's COLUMNS (and lam) over the marker
    axis: GSPMD then executes U^T av as a communication-free sharded
    contraction and U (d ∘ t) with a single psum of an N-vector — the
    per-iteration dense work scales ~1/C instead of replicating, removing
    the Amdahl term that capped 8-chip efficiency (SCALING.md)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ..sharding import MARKER_AXIS

    n = U.shape[0]
    if isinstance(K.sharding, NamedSharding):
        mesh = K.sharding.mesh
        n_dev = int(np.prod(mesh.devices.shape))
        if n_dev > 1 and n % n_dev == 0:  # NamedSharding needs divisibility
            U = jax.device_put(U, NamedSharding(mesh, P(None, MARKER_AXIS)))
            lam64 = jax.device_put(
                lam64, NamedSharding(mesh, P(MARKER_AXIS)))
    return U, lam64


def build_eigen_cached(
    fac: GramFactor,
    cache_path: str,
    seed: int = 0,
    leaf: int = 2048,
    verbose: bool = False,
    deadline: float | None = None,
) -> tuple[EigenFactor, dict]:
    """build_eigen with a persistent on-disk factor: the eigenbasis is a
    pure function of the DATASET (K), so a production rerun, a resumed job,
    or a second run mode over the same data can skip the build
    entirely.  The reference has no analog — its per-iteration CG starts
    from scratch every run (src/vamp.cpp:697-751).

    The .npz stores (U, lam, resid, ortho, n, seed, fp); on load the
    factor is validated against the live K by N, the build seed, and a
    random-probe fingerprint — the TRACE and the 8 sketch entries are
    compared SEPARATELY (both relative 1e-3): the trace of any two
    standardized same-shape Grams is ~N and would swamp a combined norm at
    production M/N ratios, while the sketch differs at O(1) relative scale
    between datasets.  A stale, corrupt, or truncated cache rebuilds and
    overwrites instead of silently corrupting (or killing) the run.

    Multi-process: the load-vs-build decision is made by the WRITER
    process and broadcast, so every process runs the same collective
    sequence (a per-process os.path.exists could disagree under shared-
    filesystem visibility lag and deadlock the collectives); only the
    writer saves (atomic per-pid tmp + rename, like engine/checkpoint.py).
    """
    import os

    from ..io.csv_writer import is_writer_process
    from ..sharding import fetch_global

    K = fac.K
    n = fac.n
    wd = K.dtype
    # fetch_global: the fingerprint of a multi-process-sharded K is itself
    # potentially non-addressable from any single process
    fp_live = np.asarray(fetch_global(_fingerprint_jit(K)), dtype=np.float64)

    def _load_valid():
        """(U, lam, resid, ortho) when the cache is present, readable, and
        matches the live dataset+seed; None otherwise (never raises)."""
        try:
            with np.load(cache_path) as z:
                if not {"U", "lam", "resid", "ortho", "n", "seed",
                        "fp"} <= set(z.files):
                    return None
                fp_old = np.asarray(z["fp"], dtype=np.float64)
                if (int(z["n"]) != n or int(z["seed"]) != seed
                        or fp_old.shape != fp_live.shape):
                    return None
                tr_ok = (abs(fp_old[0] - fp_live[0])
                         <= 1e-3 * max(abs(fp_live[0]), 1e-30))
                sk_ok = (np.linalg.norm(fp_old[1:] - fp_live[1:])
                         <= 1e-3 * max(np.linalg.norm(fp_live[1:]), 1e-30))
                if not (tr_ok and sk_ok):
                    return None
                return (np.asarray(z["U"]), np.asarray(z["lam"]),
                        float(z["resid"]), float(z["ortho"]))
        except Exception:
            return None  # unreadable/truncated file counts as a miss

    loaded = _load_valid() if os.path.exists(cache_path) else None
    if jax.process_count() > 1:
        # all processes must take the SAME branch: follow the writer
        from jax.experimental import multihost_utils

        flag = multihost_utils.broadcast_one_to_all(
            np.asarray(loaded is not None))
        if not bool(flag):
            loaded = None
        elif loaded is None:
            raise RuntimeError(
                f"eigen cache {cache_path}: valid on the writer process but "
                f"not here — the cache path must be on a shared filesystem")

    if loaded is not None:
        u_np, lam_np, resid, ortho = loaded
        U = jnp.asarray(u_np, dtype=wd)
        lam64 = jnp.asarray(np.asarray(lam_np, dtype=np.float64))
        diag = {"resid": resid, "ortho": ortho,
                "splits": 0, "leaves": 0, "loaded": True}
        U, lam64 = _shard_factor(U, lam64, K)
        return EigenFactor(U=U, lam=lam64), diag
    if os.path.exists(cache_path) and verbose:
        print(f"eigen cache {cache_path}: stale or unreadable — rebuilding",
              file=sys.stderr, flush=True)

    ef, diag = build_eigen(fac, seed=seed, leaf=leaf, verbose=verbose,
                           deadline=deadline)

    # fetch_global is COLLECTIVE (multi-process factors are mesh-sharded and
    # need an allgather) — every process must call it, then only the writer
    # touches the filesystem
    u_host = fetch_global(ef.U)
    lam_host = fetch_global(ef.lam)
    if is_writer_process():
        # per-pid tmp: two independent runs sharing one cache path must not
        # truncate each other's in-progress file (cf. engine/checkpoint.py)
        tmp = f"{cache_path}.{os.getpid()}.tmp"
        with open(tmp, "wb") as f:
            np.savez(f, U=u_host, lam=lam_host,
                     resid=diag["resid"], ortho=diag["ortho"],
                     n=n, seed=seed, fp=fp_live)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, cache_path)
    return ef, diag


# --------------------------------------------------------------------------
# per-iteration quantities (jit-traceable; tau/gam2 are traced scalars)
# --------------------------------------------------------------------------


def eigen_weights(ef: EigenFactor, tau, gam2):
    """d_i = 1/(gam2 + tau lam_i) in f64, plus T = sum d (= tr S^{-1})."""
    tau64 = jnp.asarray(tau, dtype=jnp.float64)
    gam264 = jnp.asarray(gam2, dtype=jnp.float64)
    d = 1.0 / (gam264 + tau64 * ef.lam)
    return d, jnp.sum(d)


def eigen_solve(
    dm: DesignMatrix,
    ef: EigenFactor,
    v: jax.Array,
    tau,
    gam2,
    av: jax.Array | None = None,
):
    """Exact mu = (tau A^T A + gam2 I)^{-1} v via the eigenbasis (same
    Woodbury/push-through identities as ops/spectral.py spectral_solve).
    Returns (mu, q) with q = S^{-1} A v = A mu."""
    wd = dm.wd
    tau_c = jnp.asarray(tau).astype(wd)
    gam2_c = jnp.asarray(gam2).astype(wd)
    vc = v.astype(wd)
    if av is None:
        av = ax(dm, vc)
    d, _ = eigen_weights(ef, tau, gam2)
    with _hp():
        t = ef.U.T @ av.astype(wd)
        q = ef.U @ (d.astype(wd) * t)
    mu = (vc - tau_c * atx(dm, q)) / gam2_c
    return mu, q


def eigen_traces(ef: EigenFactor, mt, tau, gam2):
    """Exact (tr Q^{-1}, tr(A^T A Q^{-1})) over the Mt real markers, f64 —
    the closed forms of ops/spectral.py spectral_traces with
    T = sum_i 1/(gam2 + tau lam_i) summed exactly in f64."""
    _, T = eigen_weights(ef, tau, gam2)
    return _trace_closed_forms(T, ef.n, mt, tau, gam2)

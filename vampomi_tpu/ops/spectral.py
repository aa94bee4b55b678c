"""Gram-space (Woodbury) LMMSE solver — the fast path.

The reference solves the LMMSE system  Q mu = v,  Q = tau A^T A + gam2 I_M
with preconditioned CG, paying **two full HBM passes over the M×N design
matrix per CG step** (reference: src/vamp.cpp:645-662, 697) — dozens to
hundreds of passes per VAMP iteration — and estimates the Onsager term and
the noise-EM trace correction with a single Hutchinson probe
(src/vamp.cpp:494-501, 504-529), which both costs a second CG solve and
injects Monte-Carlo noise into the trajectory.

On an accelerator the better algorithm exploits N << M: precompute the N×N
Gram matrix

    K = A A^T            (one matmul-bound pass over X, done once)

and per iteration Cholesky-factor the *shifted dual* matrix

    S = gam2 I_N + tau K = L L^T      (N^3/3 FLOPs)

Then every LMMSE quantity is EXACT:

  solve     Q^{-1} v = ( v - tau A^T S^{-1} A v ) / gam2     [Woodbury]
  z = A mu           = S^{-1} A v                            [push-through]
  tr(Q^{-1})         = T + (Mt - N)/gam2,  T := tr(S^{-1}) = ||L^{-1}||_F^2
  tr(A^T A Q^{-1})   = (N - gam2 T) / tau

at a cost of one Ax pass + one A^T x pass over X plus O(N^3) matmul work —
independent of the CG iteration count.  (The trace identities hold for any
Mt vs N: A^T A and K share nonzero eigenvalues {lam_i}; T sums 1/(tau lam_i
+ gam2) over all N of K's eigenvalues, zero modes of Q contribute 1/gam2
each, and the (Mt - N)/gam2 counting term absorbs them exactly.  The
push-through identity is A (gam2 I + tau A^T A)^{-1} = S^{-1} A.)

This removes the Hutchinson probe entirely — alpha2 and the gamma_w trace
correction become deterministic and unbiased, strictly more accurate than
the reference's single-probe estimator — and removes CG tolerance error
from x2_hat.

Sharding: X is marker-sharded over mesh axis "m"; the Gram build runs as a
`shard_map` of block-local (w^2-weighted) X^T X contractions followed by one
psum of an N×N array — the only O(N^2) communication, paid once per dataset.
All per-iteration dense work (Cholesky, triangular solves) is N×N and runs
replicated.

Precision: on an accelerator the work dtype is f32; cholesky(S) at the condition
numbers VAMP produces (gam2 and tau*lam within a few decades) carries
~1e-5 relative error — the same order as the reference's CG_err_tol.  The
CPU oracle path runs the identical code in f64.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from ..sharding import MARKER_AXIS
from .operator import DesignMatrix, atx, ax, design_compile_options


class GramFactor(NamedTuple):
    """The reusable LMMSE state: the Gram matrix K = A A^T.

    Valid for ALL (tau, gam2) shifts — each iteration factors
    gam2 I + tau K on the fly (cheap, matmul-bound).
    """

    K: jax.Array  # (N, N), work dtype, replicated

    @property
    def n(self) -> int:
        return self.K.shape[0]


def _gram_pieces_local(Xl, msigl, mavel, acc_dtype, block: int):
    """Block-local pieces of the Gram sum over this shard's markers.

    Returns (G, t, s2) with
        G  = X^T diag(w^2) X        (N, N)
        t  = X^T (w^2 ∘ mu)         (N,)
        s2 = sum_m w_m^2 mu_m^2     ()
    so that K = (G - t 1^T - 1 t^T + s2 11^T) / N.  Padding markers carry
    msig = 0 and drop out exactly.  Blocked over markers so the w^2-scaled
    copy of X never materializes at full size.
    """
    packed4 = Xl.dtype == jnp.uint8  # packed int4: two codes per byte
    Ml, n_cols = Xl.shape
    N = 2 * n_cols if packed4 else n_cols
    w2 = (msigl * msigl).astype(acc_dtype)
    u = w2 * mavel.astype(acc_dtype)

    block = min(block, Ml) if Ml > 0 else 1
    main = (Ml // block) * block

    G = jnp.zeros((N, N), dtype=acc_dtype)
    t = jnp.zeros((N,), dtype=acc_dtype)

    narrow = packed4 or Xl.dtype in (jnp.bfloat16, jnp.int8)

    def piece(Xb, w2b, ub):
        if packed4:
            # per-block unpack to bf16 (4-bit codes are exact there): the
            # full-width block never exceeds (block, N) bf16 transients
            from .operator import unpack_nibbles

            lo, hi = unpack_nibbles(Xb)
            Xb = jnp.concatenate([lo, hi], axis=1)
        if narrow:
            # bf16/int8 X: weight one side in bf16 and contract bf16 x bf16
            # with f32 accumulation — a SINGLE exact bf16 product (bf16
            # products are exact in f32; int8 codes are exact IN bf16).  The
            # only loss is rounding w*x to bf16, a zero-mean ~4e-3 per-entry
            # perturbation that averages to ~4e-3/sqrt(M) ~ 1e-5 on K —
            # below the f32 factor's own noise.  The f32-upcast HIGHEST
            # route runs at the f32 rate instead of the bf16 tensor-core
            # rate.
            Xb16 = Xb.astype(jnp.bfloat16) if Xb.dtype == jnp.int8 else Xb
            Db = (w2b[:, None] * Xb16.astype(acc_dtype)).astype(jnp.bfloat16)
            Gb = jnp.einsum(
                "bn,bk->nk", Db, Xb16,
                preferred_element_type=acc_dtype,
            )
            # rank-1 correction vector at full precision (mixed f32 x bf16
            # operands would silently round ub to bf16 at default precision;
            # an N-matvec per block is negligible next to the N^2 contraction)
            tb = jnp.einsum(
                "b,bn->n", ub, Xb16, preferred_element_type=acc_dtype,
                precision=jax.lax.Precision.HIGHEST,
            )
            return Gb, tb
        Xb_acc = Xb.astype(acc_dtype)
        Gb = jnp.einsum(
            "bn,bk->nk", w2b[:, None] * Xb_acc, Xb_acc,
            preferred_element_type=acc_dtype,
            # full f32 operands: reduced-precision operands (bf16, or TF32
            # on a GPU) are NOT enough for a Gram reused exactly
            precision=jax.lax.Precision.HIGHEST,
        )
        tb = ub @ Xb_acc
        return Gb, tb

    if main > 0:
        Xm = Xl[:main].reshape(-1, block, n_cols)
        w2m = w2[:main].reshape(-1, block)
        um = u[:main].reshape(-1, block)

        def step(carry, inp):
            Gc, tc = carry
            Gb, tb = piece(*inp)
            return (Gc + Gb, tc + tb), None

        (G, t), _ = jax.lax.scan(step, (G, t), (Xm, w2m, um))

    if main < Ml:
        Gb, tb = piece(Xl[main:], w2[main:], u[main:])
        G = G + Gb
        t = t + tb

    s2 = jnp.sum(u * mavel.astype(acc_dtype))
    return G, t, s2


def gram(dm: DesignMatrix, block: int = 16384) -> jax.Array:
    """K = A A^T as an (N, N) array in the operator's work dtype.

    The contraction over the (possibly sharded) marker dim is one weighted
    X^T X — M·N^2 FLOPs, a single HBM pass over X — plus rank-1
    standardization corrections (the same fusion trick as ops/operator.py).
    """
    acc = dm.wd
    opts = design_compile_options(dm.X) or None
    mesh = None
    if isinstance(dm.X.sharding, NamedSharding) and MARKER_AXIS in dm.X.sharding.spec:
        mesh = dm.X.sharding.mesh
        if np.prod(mesh.devices.shape) == 1:
            mesh = None

    if mesh is not None:
        @functools.partial(
            jax.shard_map,
            mesh=mesh,
            in_specs=(P(MARKER_AXIS, None), P(MARKER_AXIS), P(MARKER_AXIS)),
            out_specs=(P(), P(), P()),
            check_vma=False,  # scan carry is shard-local by construction
        )
        def pieces(Xl, msigl, mavel):
            G, t, s2 = _gram_pieces_local(Xl, msigl, mavel, acc, block)
            return (
                jax.lax.psum(G, MARKER_AXIS),
                jax.lax.psum(t, MARKER_AXIS),
                jax.lax.psum(s2, MARKER_AXIS),
            )

        G, t, s2 = jax.jit(pieces, compiler_options=opts)(dm.X, dm.msig, dm.mave)
    else:
        G, t, s2 = jax.jit(
            lambda X, ms, mv: _gram_pieces_local(X, ms, mv, acc, block),
            compiler_options=opts,
        )(dm.X, dm.msig, dm.mave)

    inv_n = (dm.inv_sqrt_n.astype(acc)) ** 2
    K = (G - t[:, None] - t[None, :] + s2) * inv_n
    return 0.5 * (K + K.T)  # exact symmetry for cholesky


def build_spectral(dm: DesignMatrix, block: int = 16384) -> GramFactor:
    """One-time Gram build — M·N^2 FLOPs, amortized over every LMMSE solve
    (and every (tau, gam2) shift) of the run."""
    return GramFactor(K=gram(dm, block=block))


class ShiftInverse(NamedTuple):
    """Per-iteration dense LMMSE state: the explicit inverse Cholesky factor
    of the shifted dual S = gam2 I + tau K, plus its Frobenius norm.

        W = L^{-1}  with  L L^T = S        (N, N) lower triangular
        T = ||W||_F^2 = tr(S^{-1})         () f64

    Having W explicitly makes every per-iteration quantity two matvecs:
    S^{-1} b = W^T (W b), and both VAMP traces are closed forms of T
    (see `spectral_traces`).  Replaces the factor-then-forward-substitute
    pair (`shift_cholesky` + `spectral_traces(L=...)`) with ONE fused pass.
    """

    W: jax.Array
    T: jax.Array

    def solve(self, b: jax.Array) -> jax.Array:
        """S^{-1} b via two triangular matvecs (O(N^2), HBM-bound).
        Full f32 operand precision: bf16 or TF32 operands would inject
        ~1e-3 error into the exact solve."""
        with jax.default_matmul_precision("highest"):
            return self.W.T @ (self.W @ b)


def shift_inverse(fac: GramFactor, tau, gam2, nb: int = 8) -> ShiftInverse:
    """Fused blocked Cholesky + inverse factor + trace of S = gam2 I + tau K.

    One pass produces everything the VAMP iteration needs from the dense
    N×N problem (replaces the reference's per-iteration CG solves and
    Hutchinson probes, src/vamp.cpp:494-529, 664-757, with closed forms):

      * right-looking blocked Cholesky: the N^3/3 trailing (syrk) updates are
        plain matmuls;
      * each panel is formed as `A_panel @ Wjj^T` — a matmul against the
        diagonal block's explicit inverse instead of a large triangular
        solve (triangular solves with a big right-hand side are sequential;
        whether cuSOLVER's make the matmul formulation unnecessary on the
        GPU is not measured yet);
      * the inverse factor W = L^{-1} is built left-looking row-group by
        row-group: W[i,j] = -Wii (sum_{k=j}^{i-1} L[i,k] W[k,j]) — all
        matmuls over already-final blocks, N^3/3 FLOPs exploiting W's
        block-triangular zero structure;
      * T = ||W||_F^2 accumulates per block in the work dtype, summed f64.

    The only non-matmul work is nb small (N/nb) Cholesky factorizations and
    their trtri's.  Total ~2N^3/3 FLOPs, all matmul-shaped — strictly less
    latency than the previous factor (N^3/3, partly triangular) + separate
    forward-substitution trace pass (N^3/3, partly triangular), and the
    per-iteration `cho_solve` triangular solves disappear too.
    """
    wd = fac.K.dtype
    n = fac.n
    tau_c = jnp.asarray(tau).astype(wd)
    gam2_c = jnp.asarray(gam2).astype(wd)
    S = tau_c * fac.K + gam2_c * jnp.eye(n, dtype=wd)

    nb = max(1, min(nb, n))
    bounds = np.linspace(0, n, nb + 1).astype(int)

    with jax.default_matmul_precision("highest"):
        return _shift_inverse_body(S, bounds, nb, n, wd)


_FACTOR_BASE = 256  # direct chol+trtri below this size


def _factor_diag(A):
    """(L, W = L^{-1}) of a dense SPD block by 2x2 recursion:

        A = [[A11, A21^T], [A21, A22]],  L11 W11 from A11,
        P = A21 W11^T,  Sc = A22 - P P^T,  L22 W22 from Sc,
        L = [[L11, 0], [P, L22]],  W = [[W11, 0], [-W22 P W11, W22]].

    Native cholesky/triangular-solve is row-sequential and dominated the
    blocked factor at 512-1024 block sizes on the accelerator this was first
    written for; the recursion turns all but the _FACTOR_BASE-sized leaves
    into matmuls.  Whether cuSOLVER's factorizations make this unnecessary
    on the GPU is not measured yet.
    """
    b = A.shape[0]
    if b <= _FACTOR_BASE:
        L = jnp.linalg.cholesky(A)
        W = jax.scipy.linalg.solve_triangular(
            L, jnp.eye(b, dtype=A.dtype), lower=True
        )
        return L, W
    h = (b // 2 + 127) // 128 * 128  # lane-aligned split (b > _FACTOR_BASE here)
    h = min(h, b - 1)
    L11, W11 = _factor_diag(A[:h, :h])
    P = A[h:, :h] @ W11.T
    Sc = A[h:, h:] - P @ P.T
    L22, W22 = _factor_diag(Sc)
    L = jnp.zeros_like(A)
    L = L.at[:h, :h].set(L11)
    L = L.at[h:, :h].set(P)
    L = L.at[h:, h:].set(L22)
    W = jnp.zeros_like(A)
    W = W.at[:h, :h].set(W11)
    W = W.at[h:, :h].set(-(W22 @ (P @ W11)))
    W = W.at[h:, h:].set(W22)
    return L, W


def _shift_inverse_body(S, bounds, nb, n, wd):
    """Block-dict right-looking factor + left-looking inverse.

    Every operand is an individual (bi, bj) block in a Python dict, so XLA
    never materializes a full-N^2 `.at[...]` functional update inside the
    loop (each of those costs a 4 N^2-byte HBM copy when the buffer cannot
    be aliased).
    The full W is assembled exactly once at the end with jnp.block.
    """
    spans = [(int(bounds[i]), int(bounds[i + 1])) for i in range(nb)]
    spans = [(lo, hi) for lo, hi in spans if hi > lo]
    nb = len(spans)

    Ab = {}   # trailing Schur blocks, lower triangle only: (i, j), i >= j
    for i, (ilo, ihi) in enumerate(spans):
        for j, (jlo, jhi) in enumerate(spans[: i + 1]):
            Ab[(i, j)] = S[ilo:ihi, jlo:jhi]

    Lb = {}   # sub-diagonal panels of L
    Wb = {}   # inverse-factor blocks, lower triangle
    T = jnp.asarray(0.0, dtype=jnp.float64)

    for i in range(nb):
        _, Wii = _factor_diag(Ab[(i, i)])
        Wb[(i, i)] = Wii
        T = T + jnp.sum(Wii * Wii).astype(jnp.float64)

        # panel of L: Ab[(r, i)] already carries every trailing update from
        # steps < i, so L[r, i] = A[r, i] L_ii^{-T} = A[r, i] Wii^T
        for r in range(i + 1, nb):
            Lb[(r, i)] = Ab[(r, i)] @ Wii.T
        # trailing (syrk) update, blockwise
        for r in range(i + 1, nb):
            for s in range(i + 1, r + 1):
                Ab[(r, s)] = Ab[(r, s)] - Lb[(r, i)] @ Lb[(s, i)].T

        # row-group i of the inverse factor, left-looking: every L[i, k] and
        # W[k, j] needed (k < i) is final
        for j in range(i):
            acc = Lb[(i, j)] @ Wb[(j, j)]
            for k in range(j + 1, i):
                acc = acc + Lb[(i, k)] @ Wb[(k, j)]
            Wij = -(Wii @ acc)
            Wb[(i, j)] = Wij
            T = T + jnp.sum(Wij * Wij).astype(jnp.float64)

    rows = []
    for i, (ilo, ihi) in enumerate(spans):
        row = []
        for j, (jlo, jhi) in enumerate(spans):
            if j <= i:
                row.append(Wb[(i, j)])
            else:
                row.append(jnp.zeros((ihi - ilo, jhi - jlo), dtype=wd))
        rows.append(row)
    W = jnp.block(rows) if nb > 1 else Wb[(0, 0)]
    return ShiftInverse(W=W, T=T)


def _blocked_cholesky(S: jax.Array, nb: int) -> jax.Array:
    """Right-looking blocked Cholesky: the N^3/3 trailing (syrk) updates run
    as plain matmuls."""
    n = S.shape[0]
    bounds = np.linspace(0, n, nb + 1).astype(int)
    L = jnp.zeros_like(S)
    A = S
    # full f32 operand precision: reduced-precision trailing updates can
    # lose positive-definiteness at high shift condition (NaN at cond ~ 1e5
    # with bf16 operands)
    with jax.default_matmul_precision("highest"):
        for j in range(nb):
            lo, hi = int(bounds[j]), int(bounds[j + 1])
            if hi == lo:
                continue
            Ljj = jnp.linalg.cholesky(A[lo:hi, lo:hi])
            L = L.at[lo:hi, lo:hi].set(Ljj)
            if hi < n:
                panel = jax.scipy.linalg.solve_triangular(
                    Ljj, A[hi:, lo:hi].T, lower=True
                ).T
                L = L.at[hi:, lo:hi].set(panel)
                A = A.at[hi:, hi:].add(-(panel @ panel.T))
    return L


def default_nb(n: int) -> int:
    """Block count for the fused factor: 1 (monolithic chol + trtri) below
    the size where blocking pays.  The choice of 16 panels was tuned on the
    accelerator this was first written for; on the GPU it is not measured
    yet."""
    return 16 if n >= 4096 else (8 if n >= 2048 else 1)


def shift_cholesky(fac: GramFactor, tau, gam2) -> jax.Array:
    """L with L L^T = gam2 I + tau K, in the factor's dtype."""
    wd = fac.K.dtype
    tau_c = jnp.asarray(tau).astype(wd)
    gam2_c = jnp.asarray(gam2).astype(wd)
    S = tau_c * fac.K + gam2_c * jnp.eye(fac.n, dtype=wd)
    if fac.n >= 2048:
        return _blocked_cholesky(S, nb=8)
    return jnp.linalg.cholesky(S)


def spectral_solve(
    dm: DesignMatrix,
    fac: GramFactor,
    v: jax.Array,
    tau,
    gam2,
    av: jax.Array | None = None,
    L: jax.Array | None = None,
    winv: ShiftInverse | None = None,
):
    """Exact mu = (tau A^T A + gam2 I)^{-1} v via Woodbury.

    Returns (mu, z_mu) with z_mu = A mu obtained from the push-through
    identity (no extra pass over X).  Pass `av = A v` if already available,
    plus either a fused inverse factor `winv` (preferred: S^{-1} av is two
    O(N^2) matvecs) or a shift Cholesky `L` (cho_solve fallback).
    """
    wd = dm.wd
    tau_c = jnp.asarray(tau).astype(wd)
    gam2_c = jnp.asarray(gam2).astype(wd)

    vc = v.astype(wd)
    if av is None:
        av = ax(dm, vc)
    if winv is not None:
        q = winv.solve(av.astype(wd))                         # S^{-1} A v
    else:
        if L is None:
            L = shift_cholesky(fac, tau, gam2)
        q = jax.scipy.linalg.cho_solve((L, True), av.astype(wd))
    mu = (vc - tau_c * atx(dm, q)) / gam2_c
    return mu, q  # q == A mu exactly (push-through identity)


def spectral_traces(
    fac: GramFactor, mt, tau, gam2,
    L: jax.Array | None = None,
    trace_blocks: int = 8,
    winv: ShiftInverse | None = None,
):
    """Exact (tr Q^{-1}, tr(A^T A Q^{-1})) over the Mt real markers, f64.

    Replaces the reference's Hutchinson estimates (src/vamp.cpp:494-501 for
    alpha2 = gam2 u^T Q^{-1} u and src/vamp.cpp:518-521 for the gamma_w
    trace correction) with their closed forms via T = ||L^{-1}||_F^2.

    T is computed by fully blocked forward substitution: rows above the
    diagonal block of each L^{-1} column group are structurally zero, and
    within a group the block-rows come from B×B triangular solves plus
    matmul updates — N^3/6 FLOPs, matmul-dominant.  Block sums are reduced
    in the work dtype; the cross-block accumulator is f64 (a scalar).
    """
    n = fac.n
    if winv is not None:
        # T already accumulated during the fused factor pass
        return _trace_closed_forms(winv.T, n, mt, tau, gam2)
    if L is None:
        L = shift_cholesky(fac, tau, gam2)
    nb = max(1, min(trace_blocks, n))
    bounds = np.linspace(0, n, nb + 1).astype(int)
    T = jnp.asarray(0.0, dtype=jnp.float64)
    # full f32 operand precision for the block-update matmuls (see
    # ShiftInverse.solve)
    with jax.default_matmul_precision("highest"):
        for j in range(nb):
            jlo, jhi = int(bounds[j]), int(bounds[j + 1])
            if jhi == jlo:
                continue
            Xs: dict[int, jax.Array] = {}
            for i in range(j, nb):
                ilo, ihi = int(bounds[i]), int(bounds[i + 1])
                if ihi == ilo:
                    continue
                if i == j:
                    acc = jnp.eye(ihi - ilo, jhi - jlo, dtype=L.dtype)
                else:
                    acc = jnp.zeros((ihi - ilo, jhi - jlo), dtype=L.dtype)
                for k in range(j, i):
                    if k not in Xs:  # empty block (n not divisible by nb)
                        continue
                    klo, khi = int(bounds[k]), int(bounds[k + 1])
                    acc = acc - L[ilo:ihi, klo:khi] @ Xs[k]
                Xs[i] = jax.scipy.linalg.solve_triangular(
                    L[ilo:ihi, ilo:ihi], acc, lower=True
                )
                T = T + jnp.sum(Xs[i] ** 2).astype(jnp.float64)
    return _trace_closed_forms(T, n, mt, tau, gam2)


def _trace_closed_forms(T, n, mt, tau, gam2):
    """(tr Q^{-1}, tr(A^T A Q^{-1})) from T = tr(S^{-1}) — see module
    docstring for the zero-mode counting argument."""
    tau64 = jnp.asarray(tau, dtype=jnp.float64)
    gam264 = jnp.asarray(gam2, dtype=jnp.float64)
    mt64 = jnp.asarray(mt, dtype=jnp.float64)
    T64 = jnp.asarray(T, dtype=jnp.float64)
    tr_qinv = T64 + (mt64 - n) / gam264
    tr_ata_qinv = (n - gam264 * T64) / tau64
    return tr_qinv, tr_ata_qinv

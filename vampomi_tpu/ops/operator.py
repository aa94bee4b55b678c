"""The standardized design-matrix operator A.

The reference never materializes the standardized matrix; it fuses
(X - mu) * sigma_inv into elementwise CPU loops inside `Ax`/`ATx`
(reference: src/data.cpp:294-373).  Here we instead use the algebraic
decomposition

    A x   = ( X^T (sigma_inv ∘ x) - (mu · (sigma_inv ∘ x)) 1 ) / sqrt(N)
    A^T y = sigma_inv ∘ ( X y - mu (1^T y) ) / sqrt(N)

so the hot path is a dense (M, N) matvec/matmul that XLA compiles into one
pass over X, plus O(M)+O(N) rank-1 corrections.  X is stored marker-major
(M, N) — the same layout as the input `.bin` file (reference:
simulation/data_sim.py:58) — and sharded over the mesh axis "m" in dim 0.

Communication: `A x` contracts the sharded M dim → XLA inserts one
all-reduce of an N-vector (== the reference's MPI_Allreduce(N),
src/data.cpp:367).  `A^T y` is communication-free (y replicated).

Precision policy: every M- or N-length vector lives in the *compute dtype*
(f32 by default on an accelerator, f64 for the CPU correctness oracle, bf16
optional).  The passes over X are bound by memory bandwidth, so the vector
dtype sets the bytes each pass moves; f64 appears ONLY in scalar
bookkeeping.  The standardization statistics are computed in f64 on the
host and then cast once.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..sharding import MARKER_AXIS, distribute, pad_to_multiple


# Storage-dtype marker for the packed-int4 design matrix: X holds (M, N/2)
# bytes, each carrying two 4-bit affine codes (low nibble = sample j, high
# nibble = sample j + N/2, both biased by +8 into [0, 15]).  4 bits halve
# the bytes per pass again vs int8 — 5.4 GB at the M=2^20 x N=10240
# north-star shape — at the cost of a 16-level quantizer (range/15 step vs
# int8's range/254; see quantize_markers4).
PACKED4_DTYPE = jnp.uint8


class DesignMatrix(NamedTuple):
    """Pytree holding the raw data and the fused standardization vectors.

    All vector fields are in the compute dtype; `n`/`mt` are f64 scalars
    (scalar f64 is cheap even when emulated).

    X          : (M_pad, N) raw marker data, sharded over "m" — or
                 (M_pad, N/2) packed nibbles when dtype is PACKED4_DTYPE.
    mave       : (M_pad,) per-marker mean.
    msig       : (M_pad,) per-marker inverse sd (or 1/sd^alpha); ZERO for
                 padding markers so padded columns of A are exactly 0.
    mmask      : (M_pad,) 1.0 for real markers, 0.0 for padding.
    inv_sqrt_n : () 1/sqrt(N) in compute dtype.
    n, mt      : () f64 — sample count and true (unpadded) marker count.
    """

    X: jax.Array
    mave: jax.Array
    msig: jax.Array
    mmask: jax.Array
    inv_sqrt_n: jax.Array
    n: jax.Array
    mt: jax.Array

    @property
    def m_pad(self) -> int:
        return self.X.shape[0]

    @property
    def wd(self):
        """Work dtype for vector math: f32 when X is bf16/int8/packed-int4
        (the narrow dtypes buy HBM bandwidth on the big matrix; the small
        vectors stay f32)."""
        return (
            jnp.float32
            if self.X.dtype in (jnp.bfloat16, jnp.int8, PACKED4_DTYPE)
            else self.X.dtype
        )


# XLA:GPU's autotuner times the candidate kernels of a fusion on scratch
# copies of the fusion's operands.  A fusion that reads all of X (every
# single-output pass over X, such as atx or ax at K=1) then asks for a second
# X-sized buffer, and the compile fails with RESOURCE_EXHAUSTED once X's
# shard holds about half of the device's memory (f32 X at M=2^20 x N=10240
# on an 80 GB H100, PERF.md).  Jits that read such a design compile with
# autotuning off: XLA's default kernels, no scratch copies.
_AUTOTUNE_MAX_X_SHARE = 0.4


def design_compile_options(X) -> dict:
    """XLA compile options for a jit that reads the design matrix X: none,
    unless X's per-device shard exceeds _AUTOTUNE_MAX_X_SHARE of the memory
    JAX may use on that device.  A backend that reports no memory limit
    (the CPU) never gets any."""
    limit = _memory_limit(X)
    shard = math.prod(X.sharding.shard_shape(X.shape)) * X.dtype.itemsize
    if limit and shard > _AUTOTUNE_MAX_X_SHARE * limit:
        return {"xla_gpu_autotune_level": 0}
    return {}


def _memory_limit(X) -> int:
    """Bytes JAX may use on the device of X's first local shard; 0 where the
    backend reports none."""
    stats = X.addressable_shards[0].device.memory_stats() or {}
    return stats.get("bytes_limit", 0)


def jit_for_design(fun, dm: DesignMatrix, static_argnames: tuple = ()):
    """`fun` jitted with design_compile_options(dm.X).  `fun` may already be
    a jit: its body is then compiled as part of this one, under these
    options.  One wrapper per (fun, options), so compiles are cached."""
    opts = tuple(sorted(design_compile_options(dm.X).items()))
    return _jit_with(fun, tuple(static_argnames), opts)


@functools.lru_cache(maxsize=None)
def _jit_with(fun, static_argnames: tuple, options: tuple):
    return jax.jit(fun, static_argnames=static_argnames,
                   compiler_options=dict(options) or None)


def _accum_dtype(dm: DesignMatrix):
    # narrow inputs accumulate in f32; f32/f64 natively.
    return (
        jnp.float32
        if dm.X.dtype in (jnp.bfloat16, jnp.int8, PACKED4_DTYPE)
        else dm.X.dtype
    )


def unpack_nibbles(Xp: jax.Array, dtype=jnp.bfloat16) -> tuple[jax.Array, jax.Array]:
    """(lo, hi) code halves of a packed (m, N/2) byte matrix, as `dtype`
    values in [-8, 7].  lo covers samples [0, N/2), hi covers [N/2, N).
    4-bit codes are exact in bf16 (and in int8)."""
    p = Xp.astype(jnp.int32)
    lo = ((p & 15) - 8).astype(dtype)
    hi = ((p >> 4) - 8).astype(dtype)
    return lo, hi


# Transient-memory budget for the packed-int4 unpack-einsum routes: the
# two bf16 code halves of a marker chunk are kept under this many bytes by
# processing X in marker blocks (fori_loop over dynamic slices), instead of
# materializing the full-M halves (4x the packed bytes).
_UNPACK_CHUNK_BYTES = 256 << 20


def _packed4_chunk(m: int, n2: int) -> int | None:
    """Marker-chunk length for the unpack-einsum route, or None when the whole
    (m, n2) unpack already fits the budget.  bf16 halves cost 4*m*n2 bytes."""
    if 4 * m * n2 <= _UNPACK_CHUNK_BYTES or m <= 1:
        return None
    chunk = max(256, _UNPACK_CHUNK_BYTES // (4 * n2))
    return min(m, chunk)


def _packed4_ax_chunked(Xp: jax.Array, wb: jax.Array, chunk: int) -> jax.Array:
    """A-direction unpack-einsum over marker chunks: (m, n2) packed codes,
    (m, K) bf16 weights → (N=2*n2, K) f32 accumulated across chunks, never
    holding more than one chunk's bf16 halves.

    Chunks are fori_loop dynamic slices of the ORIGINAL Xp (never a
    reshaped prefix copy): a sliced xs operand of scan/map materializes a
    near-full copy of packed X when chunk ∤ m.  The ragged tail is handled
    by clamping the final chunk's start to m - chunk; because this
    direction ACCUMULATES over chunks, the clamped chunk's overlap rows
    (already covered by the previous chunk) get their weights masked to
    zero."""
    m, n2 = Xp.shape
    k = wb.shape[1]
    nchunks = -(-m // chunk)

    def body(i, acc):
        start = jnp.minimum(i * chunk, m - chunk)
        Xc = jax.lax.dynamic_slice_in_dim(Xp, start, chunk, axis=0)
        wc = jax.lax.dynamic_slice_in_dim(wb, start, chunk, axis=0)
        fresh = (start + jnp.arange(chunk)) >= i * chunk
        wc = jnp.where(fresh[:, None], wc, jnp.zeros((), wc.dtype))
        lo, hi = unpack_nibbles(Xc)
        return acc + jnp.concatenate([
            jnp.einsum("mk,mn->nk", wc, lo, preferred_element_type=jnp.float32),
            jnp.einsum("mk,mn->nk", wc, hi, preferred_element_type=jnp.float32),
        ])

    return jax.lax.fori_loop(
        0, nchunks, body, jnp.zeros((2 * n2, k), jnp.float32))


def reduce_rows(X: jax.Array, ys: jax.Array) -> jax.Array:
    """X @ ys for int8 or packed-int4 codes X and ys (N, K) → (M, K) f32.

    One row reduction with K outputs (a variadic `lax.reduce`): the code →
    f32 convert (and the nibble unpack) fuse into it, so each byte of X is
    read once per call and no converted copy of X is written.  Each
    right-hand side is read as a contiguous row of ys.T — a strided column
    of ys inside the fusion ran 2.3x slower on the H100.  Exact code values
    and f32 ys make this the accurate route: the only rounding is f32
    accumulation (a bf16-operand einsum rounds ys to bf16, ~1e-3
    relative).  At K=1 on the H100 it matches that einsum's time (PERF.md).
    """
    yt = ys.T.astype(jnp.float32)  # (K, N)
    k = yt.shape[0]
    if X.dtype == PACKED4_DTYPE:
        n2 = X.shape[1]
        lo, hi = unpack_nibbles(X, dtype=jnp.float32)
        terms = [lo * yt[j, :n2] + hi * yt[j, n2:] for j in range(k)]
    else:
        Xf = X.astype(jnp.float32)
        terms = [Xf * yt[j] for j in range(k)]
    zero = jnp.zeros((), jnp.float32)
    sums = jax.lax.reduce(
        tuple(terms), (zero,) * k,
        lambda a, b: tuple(u + v for u, v in zip(a, b)), (1,))
    return jnp.stack(sums, axis=1)


def _bf16_operands(dm: DesignMatrix, w):
    """(X', w') einsum operands for the fused standardize-matvec.

    int8 X contracts as bf16×bf16→f32: every int8 value in [-127, 127] is
    EXACTLY representable in bf16 (8-bit mantissa covers ±256), so the cast
    is lossless and the only rounding is w → bf16 — identical error to the
    bf16-X path.
    """
    if dm.X.dtype == jnp.int8:
        return dm.X.astype(jnp.bfloat16), w.astype(jnp.bfloat16)
    return dm.X, w.astype(dm.X.dtype)


def ax(dm: DesignMatrix, x: jax.Array) -> jax.Array:
    """z = A x for x (M_pad,) → (N,), in the work dtype.

    Matches reference `data::Ax` (src/data.cpp:340-373): per-marker
    (X_j - mu_j) * sigma_inv_j * x_j accumulated over markers, then / sqrt(N).
    """
    if dm.X.dtype == PACKED4_DTYPE:
        # K=1 case of the batch path: its unpack-einsum processes X in
        # marker chunks (_packed4_ax_chunked), keeping the bf16 transient
        # under _UNPACK_CHUNK_BYTES instead of 4x the packed bytes.
        return ax_batch(dm, x[:, None])[:, 0]
    w = dm.msig * x.astype(dm.wd)
    Xo, wo = _bf16_operands(dm, w)
    z = jnp.einsum(
        "m,mn->n", wo, Xo,
        preferred_element_type=_accum_dtype(dm),
        precision=jax.lax.Precision.HIGHEST,
    )
    corr = jnp.dot(dm.mave, w)
    return (z.astype(dm.wd) - corr.astype(dm.wd)) * dm.inv_sqrt_n


def atx(dm: DesignMatrix, y: jax.Array) -> jax.Array:
    """v = A^T y for y (N,) → (M_pad,), padded entries exactly 0.

    Matches reference `data::ATx` (src/data.cpp:315-333).  Quantized X
    takes the fused row reduction (`reduce_rows`)."""
    return atx_batch(dm, y[:, None])[:, 0]


def ax_batch(dm: DesignMatrix, xs: jax.Array) -> jax.Array:
    """A @ xs for xs (M_pad, K) → (N, K). Shares the pass over X across
    the K right-hand sides (the multi-RHS CG building block)."""
    w = dm.msig[:, None] * xs.astype(dm.wd)
    if dm.X.dtype == PACKED4_DTYPE:
        wb = w.astype(jnp.bfloat16)
        chunk = _packed4_chunk(dm.X.shape[0], dm.X.shape[1])
        if chunk is not None:
            z = _packed4_ax_chunked(dm.X, wb, chunk)
        else:
            lo, hi = unpack_nibbles(dm.X)
            z = jnp.concatenate([
                jnp.einsum("mk,mn->nk", wb, lo,
                           preferred_element_type=jnp.float32),
                jnp.einsum("mk,mn->nk", wb, hi,
                           preferred_element_type=jnp.float32),
            ])
    else:
        Xo, wo = _bf16_operands(dm, w)
        z = jnp.einsum(
            "mk,mn->nk", wo, Xo,
            preferred_element_type=_accum_dtype(dm),
            precision=jax.lax.Precision.HIGHEST,
        )
    corr = dm.mave @ w  # (K,)
    return (z.astype(dm.wd) - corr[None, :].astype(dm.wd)) * dm.inv_sqrt_n


def atx_batch(dm: DesignMatrix, ys: jax.Array) -> jax.Array:
    """A^T @ ys for ys (N, K) → (M_pad, K), one pass over X for all K."""
    yc = ys.astype(dm.wd)
    if dm.X.dtype in (jnp.int8, PACKED4_DTYPE):
        xy = reduce_rows(dm.X, yc)
    else:
        Xo, yo = _bf16_operands(dm, yc)
        xy = jnp.einsum(
            "mn,nk->mk", Xo, yo,
            preferred_element_type=_accum_dtype(dm),
            precision=jax.lax.Precision.HIGHEST,
        )
    v = dm.msig[:, None] * (xy.astype(dm.wd) - jnp.outer(dm.mave, jnp.sum(yc, axis=0)))
    return v * dm.inv_sqrt_n


def normal_eq_mult(dm: DesignMatrix, v: jax.Array, tau, gam2) -> jax.Array:
    """(tau · A^T A + gam2 · I) v — the LMMSE system operator.

    Reference `vamp::lmmse_mult` (src/vamp.cpp:645-662).  Accepts (M_pad,)
    or (M_pad, K); K right-hand sides share the two passes over X.
    """
    tau_c = jnp.asarray(tau).astype(dm.wd)
    gam2_c = jnp.asarray(gam2).astype(dm.wd)
    vc = v.astype(dm.wd)
    if v.ndim == 1:
        return tau_c * atx(dm, ax(dm, vc)) + gam2_c * vc
    return tau_c * atx_batch(dm, ax_batch(dm, vc)) + gam2_c * vc


def inv_sd_from_sumsq(sumsq: np.ndarray, n: int, alpha_scale: float) -> np.ndarray:
    """msig = 1/sd^alpha (reference src/data.cpp:270-276) from the centered
    sum of squares, (n-1) denominator; constant markers get msig = 1."""
    sumsq = np.asarray(sumsq, dtype=np.float64)
    with np.errstate(divide="ignore"):
        sd = np.sqrt(sumsq / (n - 1.0))
        return np.where(sumsq != 0.0, 1.0 / np.where(sd == 0, 1.0, sd) ** alpha_scale, 1.0)


def _host_stats(X_raw: np.ndarray, alpha_scale: float):
    """f64 host-side standardization statistics (bit-faithful regardless of
    the on-device compute dtype)."""
    stats = np.asarray(X_raw, dtype=np.float64)
    n = stats.shape[1]
    mave = stats.sum(axis=1) / n
    sumsqr = ((stats - mave[:, None]) ** 2).sum(axis=1)
    return mave, inv_sd_from_sumsq(sumsqr, n, alpha_scale)


def _vector_dtype(compute_dtype):
    d = jnp.dtype(compute_dtype)
    if d in (jnp.bfloat16, jnp.dtype(jnp.int8), jnp.dtype(PACKED4_DTYPE)):
        return jnp.float32
    return d


def quantize_markers(X_rows: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-marker affine int8 quantization of raw marker rows.

        X ≈ s[:, None] * Xq + z[:, None],   Xq ∈ [-127, 127]

    with s = range/254 and z the range midpoint (f64, host side).  Constant
    markers get s = 1, z = value, Xq = 0 — their A rows are exactly zero
    after standardization, as in the f32/bf16 paths.

    Why affine-per-marker: methylation beta values live in [0, 1] with
    marker-specific sub-ranges (reference simulation/sim_top_iid.py:8-30),
    so a per-marker window loses only range/254 ≈ 0.4% of a marker's sd —
    the same order as rounding X to bf16, but at HALF the bytes: the fused
    matvec is bound by memory bandwidth, so 1-byte elements double the
    markers a card holds AND the markers each pass covers per second.  The
    affine transform folds EXACTLY into the existing
    standardization vectors (see build_design), so no operator code paths
    change: A = msig_eff ∘ (Xq - mave_eff) with msig_eff = msig·s and
    mave_eff = (mave - z)/s.
    """
    X = np.asarray(X_rows, dtype=np.float64)
    mn = X.min(axis=1)
    mx = X.max(axis=1)
    rng = mx - mn
    s = np.where(rng > 0.0, rng / 254.0, 1.0)
    z = 0.5 * (mn + mx)
    Xq = np.clip(
        np.rint((X - z[:, None]) / s[:, None]), -127, 127
    ).astype(np.int8)
    return Xq, s, z


def quantize_markers4(X_rows: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-marker affine 4-bit quantization: X ≈ s[:, None] * Xq + z[:, None]
    with Xq ∈ [-8, 7], s = range/15, z positioned so the row extremes map to
    the code extremes.  Same folding algebra as quantize_markers (int8) —
    the codes standardize EXACTLY through the mave/msig vectors — but a
    16-level quantizer: per-entry error ≤ range/30, i.e. sd-relative noise
    ~(1/15)/sqrt(12) ≈ 1.9% for full-range markers (vs 0.11% for int8).
    The payoff is bytes: packed 2-per-byte, half the int8 footprint.
    """
    X = np.asarray(X_rows, dtype=np.float64)
    mn = X.min(axis=1)
    mx = X.max(axis=1)
    rng = mx - mn
    s = np.where(rng > 0.0, rng / 15.0, 1.0)
    z = np.where(rng > 0.0, mn + 8.0 * s, X[:, 0])  # -8 ↦ mn, +7 ↦ mx
    Xq = np.clip(
        np.rint((X - z[:, None]) / s[:, None]), -8, 7
    ).astype(np.int8)  # constant rows: z = value, s = 1 → codes exactly 0
    return Xq, s, z


def pack_nibbles_host(codes: np.ndarray) -> np.ndarray:
    """(M, N) int4 codes in [-8, 7] → (M, N/2) packed bytes: low nibble =
    sample j, high nibble = sample j + N/2, biased by +8 (host numpy)."""
    m, n = codes.shape
    if n % 2 != 0:
        raise ValueError("packed-int4 designs need an even sample count N")
    b = (codes + 8).astype(np.uint8)
    return b[:, : n // 2] | (b[:, n // 2 :] << 4)


def dequantized_stats(
    Xq: np.ndarray, s: np.ndarray, z: np.ndarray, alpha_scale: float
) -> tuple[np.ndarray, np.ndarray]:
    """(mave, msig) of the DEQUANTIZED values s·Xq + z, computed from the
    int8 codes alone (no f64 re-materialization): standardizing against the
    dequantized statistics makes each A row have exactly zero mean and unit
    sd^alpha for the matrix actually used in the solve."""
    Xq = np.asarray(Xq)
    n = Xq.shape[1]
    qmean = Xq.astype(np.float64).mean(axis=1)
    qsumsq = ((Xq.astype(np.float64) - qmean[:, None]) ** 2).sum(axis=1)
    mave = s * qmean + z
    msig_unit = inv_sd_from_sumsq(qsumsq, n, alpha_scale)  # of Xq itself
    # sd(s·Xq) = s·sd(Xq): fold s^alpha into the inverse sd
    msig = np.where(qsumsq != 0.0, msig_unit / s**alpha_scale, 1.0)
    return mave, msig


def _assemble(X_host, mave_host, msig_host, mmask_host, n, mt, mesh, compute_dtype):
    vd = np.dtype(_vector_dtype(compute_dtype))
    if mesh is not None:
        X = distribute(X_host, mesh, P(MARKER_AXIS, None))
        mave = distribute(mave_host.astype(vd), mesh, P(MARKER_AXIS))
        msig = distribute(msig_host.astype(vd), mesh, P(MARKER_AXIS))
        mmask = distribute(mmask_host.astype(vd), mesh, P(MARKER_AXIS))
    else:
        X = jnp.asarray(X_host)
        mave = jnp.asarray(mave_host.astype(vd))
        msig = jnp.asarray(msig_host.astype(vd))
        mmask = jnp.asarray(mmask_host.astype(vd))
    return DesignMatrix(
        X=X,
        mave=mave,
        msig=msig,
        mmask=mmask,
        inv_sqrt_n=jnp.asarray(1.0 / np.sqrt(float(n)), dtype=vd),
        n=jnp.asarray(float(n), dtype=jnp.float64),
        mt=jnp.asarray(float(mt), dtype=jnp.float64),
    )


def build_design(
    X_raw: np.ndarray | jax.Array,
    mesh: Mesh | None = None,
    compute_dtype=jnp.float32,
    alpha_scale: float = 1.0,
    mt: int | None = None,
    stats: tuple[np.ndarray, np.ndarray] | None = None,
    quant_out: dict | None = None,
) -> DesignMatrix:
    """Construct a (optionally mesh-sharded) DesignMatrix from raw (Mt, N)
    marker-major data.

    Pads M up to a multiple of the mesh size; padded markers have msig = 0 and
    mmask = 0 so they contribute exactly nothing to any product or reduction.

    `stats` = precomputed f64 (mave, msig) for the Mt real markers — supplied
    by the fused native ingest (io/bin_io.py read_meth_bin_stats), which
    computes them in the same threaded pass that narrows the file to f32.

    `quant_out`, if given, receives {"scale": s, "zero": z} (length Mt f64)
    when the design is quantized — the per-marker affine dequantization
    X ≈ s·Xq + z that downstream raw-marker consumers (the LOO association
    add-back, modes/association.py) need to map code-space moments back to
    raw units.
    """
    X_raw = np.asarray(X_raw)
    Mt_true = int(mt if mt is not None else X_raw.shape[0])
    N = X_raw.shape[1]

    n_shards = int(np.prod(mesh.devices.shape)) if mesh is not None else 1
    M_pad = pad_to_multiple(Mt_true, n_shards)

    cd = np.dtype(compute_dtype)
    packed4 = cd == np.dtype(PACKED4_DTYPE)
    quant = cd == np.dtype(np.int8) or packed4
    if quant:
        X_store, qs, qz = (
            quantize_markers4(X_raw) if packed4 else quantize_markers(X_raw)
        )
        if quant_out is not None:
            quant_out["scale"] = qs
            quant_out["zero"] = qz
    else:
        X_store = X_raw

    codes = X_store  # int codes for quantized builds (pre-packing view)
    if packed4:
        X_store = pack_nibbles_host(X_store)  # codes → (Mt, N/2) bytes
    n_cols = X_store.shape[1]
    if M_pad != Mt_true:
        X_host = np.zeros((M_pad, n_cols), dtype=cd)
        X_host[:Mt_true] = np.asarray(X_store, dtype=cd)
        if packed4:
            # padding rows must decode to code 0 (bias 8 in both nibbles);
            # their msig = 0 zeroes them in every product regardless, but
            # keeping the decode at 0 also keeps debug dumps sane
            X_host[Mt_true:] = 0x88
    else:
        X_host = np.asarray(X_store, dtype=cd)

    mave_host = np.zeros((M_pad,), dtype=np.float64)
    msig_host = np.zeros((M_pad,), dtype=np.float64)
    if quant:
        # statistics of the dequantized values: the stored matrix is then
        # standardized EXACTLY (zero-mean, unit sd^alpha rows).  Caller-
        # supplied `stats` are deliberately IGNORED here: they describe the
        # raw f64 data, and folding them would leave the code matrix with a
        # quantization-sized mean/sd bias (round-3 advisor finding) — the
        # guarantee is standardization against the matrix actually solved.
        mave_host[:Mt_true], msig_host[:Mt_true] = dequantized_stats(
            codes, qs, qz, alpha_scale
        )
    elif stats is not None:
        mave_host[:Mt_true] = stats[0][:Mt_true]
        msig_host[:Mt_true] = stats[1][:Mt_true]
    else:
        mave_host[:Mt_true], msig_host[:Mt_true] = _host_stats(X_raw, alpha_scale)
    if quant:
        # fold the affine dequantization into the standardization vectors:
        # msig∘(s·Xq + z - mave) == (msig·s)∘(Xq - (mave - z)/s)
        mave_host[:Mt_true] = (mave_host[:Mt_true] - qz) / qs
        msig_host[:Mt_true] = msig_host[:Mt_true] * qs
    mmask_host = np.zeros((M_pad,), dtype=np.float64)
    mmask_host[:Mt_true] = 1.0

    return _assemble(X_host, mave_host, msig_host, mmask_host, N, Mt_true, mesh, compute_dtype)


def build_design_multihost(
    local_rows: np.ndarray,
    global_start: int,
    mt: int,
    m_pad: int,
    n: int,
    mesh: Mesh,
    compute_dtype,
    alpha_scale: float = 1.0,
    stats: tuple[np.ndarray, np.ndarray] | None = None,
    quant_out: dict | None = None,
) -> DesignMatrix:
    """Multi-host construction: each process contributes its contiguous block
    of padded marker rows (marker statistics are per-row, so no cross-host
    reduction is needed — N is always fully local, like the reference's
    data.cpp:295,342).  `stats` = fused-ingest (mave, msig) for the local
    rows, as in build_design.  `quant_out`, when given, receives the
    LOCAL per-marker dequantization scale under "scale_local" for
    quantized dtypes (callers gather it across processes — Dataset.qscale
    is global)."""
    from jax.sharding import NamedSharding

    per = local_rows.shape[0]
    idx = np.arange(global_start, global_start + per)
    real = idx < mt

    cd = np.dtype(compute_dtype)
    vd = np.dtype(_vector_dtype(compute_dtype))

    if cd in (np.dtype(np.int8), np.dtype(PACKED4_DTYPE)):
        # per-marker quantization is purely row-local: no cross-host state
        packed4 = cd == np.dtype(PACKED4_DTYPE)
        Xq, qs, qz = (
            quantize_markers4(local_rows) if packed4
            else quantize_markers(local_rows)
        )
        # ignore caller-supplied raw-data stats for quantized designs —
        # same reasoning as build_design: standardize against the codes
        mave_l, msig_l = dequantized_stats(Xq, qs, qz, alpha_scale)
        mave_l = (np.asarray(mave_l, dtype=np.float64) - qz) / qs
        msig_l = np.asarray(msig_l, dtype=np.float64) * qs
        if quant_out is not None:
            quant_out["scale_local"] = np.asarray(qs, dtype=np.float64)
        local_rows = pack_nibbles_host(Xq) if packed4 else Xq
    else:
        mave_l, msig_l = (
            stats if stats is not None else _host_stats(local_rows, alpha_scale)
        )
    mave_l = np.where(real, mave_l, 0.0)
    msig_l = np.where(real, msig_l, 0.0)
    mmask_l = real.astype(np.float64)

    def g(local, spec, dtype):
        sh = NamedSharding(mesh, spec)
        return jax.make_array_from_process_local_data(
            sh, np.asarray(local, dtype=dtype)
        )

    return DesignMatrix(
        X=g(local_rows, P(MARKER_AXIS, None), cd),
        mave=g(mave_l, P(MARKER_AXIS), vd),
        msig=g(msig_l, P(MARKER_AXIS), vd),
        mmask=g(mmask_l, P(MARKER_AXIS), vd),
        inv_sqrt_n=jnp.asarray(1.0 / np.sqrt(float(n)), dtype=vd),
        n=jnp.asarray(float(n), dtype=jnp.float64),
        mt=jnp.asarray(float(mt), dtype=jnp.float64),
    )

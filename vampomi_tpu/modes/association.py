"""`association_test` run mode: SE and LOO p-values.

SE (reference src/main_meth.cpp:220-244): p_j = Phi(0; r1_j, sqrt(1/(gam1 N))),
flipped for r1_j <= 0; written to `<out>_it_<k>_pval_se.bin`.

LOO (reference src/main_meth.cpp:245-264 + src/data.cpp:385-417): leave-one-
out per-marker regression.  The reference's O(M·N) serial loop is replaced by
closed-form sufficient statistics around a single A-pass:

  y_mark^{(j)} = (y - z1) + X_j x̂_j / sqrt(N)      (raw X_j — quirk Q5)

  sumy_j   = Σ y_mod + sumx_j x̂_j / sqrt(N)
  sumxy_j  = (X y_mod)_j + sumsqx_j x̂_j / sqrt(N)
  sumsqy_j = ||y_mod||² + 2 x̂_j/sqrt(N) (X y_mod)_j + x̂_j²/N sumsqx_j

then the 1-D regression t-test (reference src/utilities.cpp:269-282) done
with scipy's Student-t survival function.

Beyond the reference: `--pval-method loo_std` adds back the STANDARDIZED
marker contribution msig_j (X_j - mave_j) x̂_j / sqrt(N) — exactly what z1
subtracted — instead of the reference's raw-marker quirk (Q5,
src/data.cpp:405).  The raw add-back under- or over-restores marker j's own
fitted effect by the factor msig_j (methylation sds are ≪ 1, so msig ≫ 1),
which leaves part of the marker's fitted signal in the "leave-one-out"
residual and makes the quirk p-values anti-conservative at production scale
(a round-5 production run saw 4 false positives at Bonferroni vs 0 for SE).
The 1-D regression itself still uses the raw marker — the t statistic depends
only on corr(x, y), which is invariant to per-marker affine maps, so only
the add-back differs.  Default stays `loo` (reference parity).
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
from scipy.stats import norm, t as student_t

from ..config import RunConfig
from ..dataset import Dataset
from ..io.bin_io import parse_iteration, read_bin_slab, write_bin_slab
from ..ops.operator import (
    PACKED4_DTYPE, ax, jit_for_design, reduce_rows, unpack_nibbles,
)


def pvals_se(r1: np.ndarray, gam1: float, n: int) -> np.ndarray:
    scale = np.sqrt(1.0 / (gam1 * float(n)))
    p = norm.cdf(0.0, loc=r1, scale=scale)
    return np.where(r1 <= 0.0, 1.0 - p, p)


def linear_reg1d_pvals(sumx, sumsqx, sumxy, sumy, sumsqy, n: int) -> np.ndarray:
    """Vectorized port of the reference's 1-D regression t-test
    (src/utilities.cpp:269-282)."""
    s2y = (sumsqy - sumy * sumy / n) / (n - 1)
    s2x = (sumsqx - sumx * sumx / n) / (n - 1)
    sxy = (sumxy - sumx * sumy / n) / (n - 1)
    rxy = sxy / np.sqrt(s2x * s2y)
    tstat = rxy * np.sqrt((n - 2) / (1.0 - rxy * rxy))
    return 2.0 * student_t.sf(np.abs(tstat), df=n - 2)


@jax.jit
def _loo_stats(dm, y_mod):
    """Per-marker stored-X moments and the X @ y_mod matvec (f64 only for
    the O(M) outputs).  For a quantized design these are CODE-space moments
    — the t-test is invariant to per-marker affine maps, so the caller only
    rescales the add-back coefficient (pvals_loo).

    The converts feeding the reductions fuse into the reads (no full-size
    X copy materializes); quantized codes are exact in f32 and the matvec
    keeps y_mod in f32 (ops/operator.py reduce_rows), so the only
    rounding on the narrow paths is f32 accumulation — and, for bf16 X,
    y_mod → bf16 in the matvec (~1e-3 relative on xy, far below the
    quantizer's own perturbation)."""
    acc = dm.wd  # f32 for narrow X, else X's own dtype
    if dm.X.dtype == PACKED4_DTYPE:
        lo, hi = unpack_nibbles(dm.X, dtype=jnp.float32)
        sumx = (jnp.sum(lo, axis=1) + jnp.sum(hi, axis=1)).astype(jnp.float64)
        sumsqx = (jnp.sum(lo * lo, axis=1) + jnp.sum(hi * hi, axis=1)).astype(jnp.float64)
    else:
        Xa = dm.X.astype(acc)
        sumx = jnp.sum(Xa, axis=1).astype(jnp.float64)
        sumsqx = jnp.sum(Xa * Xa, axis=1).astype(jnp.float64)
    if dm.X.dtype in (jnp.int8, PACKED4_DTYPE):
        xy = reduce_rows(dm.X, y_mod[:, None])[:, 0].astype(jnp.float64)
    elif dm.X.dtype == jnp.bfloat16:
        xy = jnp.einsum(
            "mn,n->m", dm.X, y_mod.astype(jnp.bfloat16),
            preferred_element_type=jnp.float32,
        ).astype(jnp.float64)
    else:
        xy = jnp.einsum(
            "mn,n->m", dm.X, y_mod.astype(dm.X.dtype),
            preferred_element_type=acc,
            # this pass feeds p-values: full f32 operands, never TF32
            precision=jax.lax.Precision.HIGHEST,
        ).astype(jnp.float64)
    return sumx, sumsqx, xy


def pvals_loo(
    ds: Dataset, x1_hat_scaled_up: np.ndarray, standardized: bool = False
) -> np.ndarray:
    """x1_hat_scaled_up: estimate * sqrt(N) (internal scale), length Mt.

    standardized=False reproduces the reference's raw-marker add-back (Q5,
    src/data.cpp:405); True adds back the standardized column that z1
    actually used: y_mark = y_mod + c_j X_j - d_j with c_j = msig_j x̂_j/√N,
    d_j = c_j·mave_j (for the quirk, c_j = x̂_j/√N, d_j = 0).
    """
    dm = ds.dm
    n = int(dm.n)
    mt = int(dm.mt)
    m_pad = dm.m_pad

    xp = np.zeros(m_pad)
    xp[:mt] = x1_hat_scaled_up
    z1 = np.asarray(jit_for_design(ax, dm)(dm, jnp.asarray(xp)))
    y_mod = ds.phen.y - z1

    sumx, sumsqx, xy = (np.asarray(a)[:mt] for a in jit_for_design(_loo_stats, dm)(dm, jnp.asarray(y_mod)))
    xh = x1_hat_scaled_up / np.sqrt(n)
    quantized = dm.X.dtype in (jnp.int8, PACKED4_DTYPE)
    if standardized:
        # for a quantized design dm.msig/dm.mave are the code-space folded
        # vectors, so these coefficients are already in code units
        c = np.asarray(dm.msig, dtype=np.float64)[:mt] * xh
        d = c * np.asarray(dm.mave, dtype=np.float64)[:mt]
    elif quantized:
        # raw marker X_j = s_j q_j + z_j: the quirk's raw-unit add-back
        # xh·X_j becomes (xh·s_j)·q_j in code space, plus the constant
        # xh·z_j — a uniform shift of y_mark that the t statistic is
        # invariant to, so it is dropped (d = 0)
        if ds.qscale is None:
            raise ValueError(
                "LOO raw-marker add-back on a quantized design needs the "
                "dequantization scale; load the dataset via load_dataset "
                "(Dataset.qscale) or use --pval-method loo_std"
            )
        c = xh * np.asarray(ds.qscale, dtype=np.float64)[:mt]
        d = np.zeros(mt)
    else:
        c = xh
        d = np.zeros(mt)
    sum_ymod = float(np.sum(y_mod))
    ss_ymod = float(np.dot(y_mod, y_mod))

    sumy = sum_ymod + c * sumx - n * d
    sumxy = xy + c * sumsqx - d * sumx
    sumsqy = (
        ss_ymod + c * c * sumsqx + n * d * d
        + 2.0 * c * xy - 2.0 * d * sum_ymod - 2.0 * c * d * sumx
    )

    return linear_reg1d_pvals(sumx, sumsqx, sumxy, sumy, sumsqy, n)


def run_association_test(ds: Dataset, cfg: RunConfig) -> np.ndarray:
    mt = int(ds.dm.mt)
    n = int(ds.dm.n)

    if cfg.pval_method == "se":
        it_str = parse_iteration(cfg.r1_file)
        r1 = read_bin_slab(cfg.r1_file, mt)
        pvals = pvals_se(r1, cfg.gam1, n)
        out = os.path.join(cfg.out_dir, f"{cfg.out_name}_it_{it_str}_pval_se.bin")
    elif cfg.pval_method in ("loo", "loo_std"):
        it_str = parse_iteration(cfg.estimate_file)
        x1 = read_bin_slab(cfg.estimate_file, mt) * np.sqrt(float(n))
        pvals = pvals_loo(ds, x1, standardized=cfg.pval_method == "loo_std")
        out = os.path.join(
            cfg.out_dir, f"{cfg.out_name}_it_{it_str}_pval_{cfg.pval_method}.bin"
        )
    else:
        raise ValueError(f"unknown pval method {cfg.pval_method}")

    write_bin_slab(out, pvals)
    return pvals

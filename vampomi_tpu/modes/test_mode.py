"""Out-of-sample `test` run mode.

Linear (reference src/main_meth.cpp:112-205): for each saved iteration's
estimate, rescale by sqrt(N_test), predict z = A_test x, and record
R2 = 1 - ||y - z||^2 / (sigma_y^2 N) and Corr(z, y)^2 into `_test.csv`.

Probit (reference src/main_meth_probit.cpp:104-200): confusion matrix of
Phi(z) >= 0.5 against the 0/1 labels, rows [TP, TN, FP, FN, ACC]; note the
probit test CSV has NO header row (the reference never writes one).
"""

from __future__ import annotations

import os

import jax
import numpy as np
from scipy.special import ndtr

from ..config import RunConfig
from ..dataset import Dataset
from ..io.bin_io import read_bin_slab, read_vec_from_text, substitute_iteration
from ..io.csv_writer import PositionalCSV
from ..ops.operator import ax_batch, jit_for_design


def _read_estimate(est_file_it: str, mt: int) -> np.ndarray:
    # extension = everything after the basename's FIRST dot (reference
    # main_meth.cpp:151-152, scoped to the filename so dotted dirs work)
    base = os.path.basename(est_file_it)
    ext = base[base.find(".") + 1 :]
    if ext == "bin":
        return read_bin_slab(est_file_it, mt)
    return read_vec_from_text(est_file_it, mt)


def _collect_predictions(ds: Dataset, cfg: RunConfig, chunk: int = 16):
    """Yield (iteration, z) for every saved estimate in test_iter_range.

    Estimates are batched column-wise so `chunk` iterations share each
    pass over the test design matrix (multi-RHS ax_batch) instead of
    the reference's one-full-pass-per-iteration loop (main_meth.cpp:163-202).
    """
    mt = int(ds.dm.mt)
    m_pad = ds.dm.m_pad
    scale = np.sqrt(float(cfg.N_test))

    lo, hi = cfg.test_iter_range
    pending = []
    for it in range(lo, hi + 1):
        est_file_it = substitute_iteration(cfg.estimate_file, it)
        if not os.path.exists(est_file_it):
            continue
        pending.append((it, est_file_it))

    for i in range(0, len(pending), chunk):
        grp = pending[i : i + chunk]
        cols = np.zeros((m_pad, len(grp)))
        for k, (_, f) in enumerate(grp):
            x_est = _read_estimate(f, mt)
            cols[: len(x_est), k] = x_est * scale
        prod = jit_for_design(ax_batch, ds.dm)
        Z = np.asarray(prod(ds.dm, jax.numpy.asarray(cols)))
        for k, (it, _) in enumerate(grp):
            yield it, Z[:, k]


def run_test_linear(ds: Dataset, cfg: RunConfig) -> list[list[float]]:
    y = ds.phen.y
    # stdev with the (n-1) denominator (reference utilities.cpp:183-205);
    # constant across iterations
    stdev = float(np.std(y, ddof=1))

    out = PositionalCSV(
        os.path.join(cfg.out_dir, cfg.out_name + "_test.csv"),
        ["iteration", "R2 test", "z correlation test"],
    )

    rows = []
    for it, z in _collect_predictions(ds, cfg):
        l2 = float(np.sum((y - z) ** 2))
        r2 = 1.0 - l2 / (stdev * stdev * len(y))
        # zero-norm guard: an all-zero estimate (e.g. iteration 1 of a cold
        # start) predicts z = 0; the reference divides by 0 here and writes
        # NaN (src/main_meth.cpp:181-192) — deliberate divergence, matching
        # engine/metrics.py's guard
        den = float(np.sqrt(np.dot(z, z) * np.dot(y, y)))
        corr = float(np.dot(z, y)) / den if den > 0.0 else 0.0
        row = [r2, corr * corr]
        rows.append(row)
        out.write_row(it, row)
    return rows


def run_test_probit(ds: Dataset, cfg: RunConfig) -> list[list[float]]:
    y = ds.phen.y

    # probit test csv: rows only, no header (src/main_meth_probit.cpp:106-199)
    from ..io.csv_writer import is_writer_process

    path = os.path.join(cfg.out_dir, cfg.out_name + "_test.csv")
    if is_writer_process():
        if os.path.exists(path):
            os.remove(path)
        open(path, "wb").close()
    out = PositionalCSV(path, [], create=False)

    rows = []
    for it, z in _collect_predictions(ds, cfg):
        yhat = (ndtr(z) >= 0.5).astype(np.float64)
        tp = int(np.sum((y == 1) & (yhat == 1)))
        tn = int(np.sum((y == 0) & (yhat == 0)))
        fp = int(np.sum((y == 0) & (yhat == 1)))
        fn = int(np.sum((y == 1) & (yhat == 0)))
        acc = (tp + tn) / max(tp + tn + fp + fn, 1)
        row = [float(tp), float(tn), float(fp), float(fn), acc]
        rows.append(row)
        out.write_row(it, row)
    return rows

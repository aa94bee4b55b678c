"""`predict` run mode (probit driver; reference
src/main_meth_probit.cpp:201-227): z_hat = A_test (x_est * sqrt(N_test))
written as text, one value per line with C++ default stream formatting
(6 significant digits), to `<estimate prefix>.yhat`."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..config import RunConfig
from ..dataset import Dataset
from ..io.bin_io import read_bin_slab
from ..ops.operator import ax, jit_for_design


def run_predict(ds: Dataset, cfg: RunConfig) -> np.ndarray:
    mt = int(ds.dm.mt)
    n_test = cfg.N_test

    est_file = cfg.estimate_file
    pos_it = est_file.rfind("it")
    if pos_it < 0:
        raise SystemExit(
            f"FATAL  : --estimate-file must contain an 'it_<k>' tag "
            f"(reference src/main_meth_probit.cpp:204-209): {est_file!r}"
        )
    pred_file = est_file[:pos_it] + ".yhat"

    x_est = read_bin_slab(est_file, mt) * np.sqrt(float(n_test))
    xp = np.zeros(ds.dm.m_pad)
    xp[:mt] = x_est
    z = np.asarray(jit_for_design(ax, ds.dm)(ds.dm, jnp.asarray(xp)))

    with open(pred_file, "w") as f:
        for v in z:
            f.write(f"{v:g}\n")
    return z

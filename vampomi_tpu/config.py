"""Run configuration mirroring the reference's `Options`
(src/options.hpp:62-105 — defaults follow the CODE, which disagrees with the
README table; see SURVEY Q7)."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


DEFAULT_VARS = [0.0, 1e-06, 6e-06, 3e-05, 2e-04, 1e-03, 6e-03, 3e-02, 2e-01, 1.0]
DEFAULT_PROBS = [
    9.90000e-01, 5.00000e-03, 2.50000e-03, 1.25000e-03, 6.25000e-04,
    3.12500e-04, 1.56250e-04, 7.81250e-05, 3.90625e-05, 3.90625e-05,
]


@dataclass
class RunConfig:
    # files
    meth_file: str = ""
    meth_file_test: str = ""
    phen_file: str = ""
    phen_file_test: str = ""
    true_signal_file: str = ""
    estimate_file: str = ""
    r1_file: str = ""
    cov_estimate_file: str = ""
    cov_file: str = ""
    cov_file_test: str = ""
    out_dir: str = ""
    out_name: str = ""

    # mode / model
    run_mode: str = "infere"           # infere | test | association_test | predict
    model: str = "linear"              # linear | bin_class
    pval_method: str = "se"            # se | loo | loo_std (ours)

    # dimensions
    Mt: int = 0
    N: int = 0
    N_test: int = 0
    Mt_test: int = 0
    C: int = 0

    # VAMP hyperparameters (defaults = options.hpp:79-104)
    stop_criteria_thr: float = 0.01
    merge_vars_thr: float = 5e-1
    EM_err_thr: float = 1e-2
    EM_max_iter: int = 1
    CG_max_iter: int = 500
    CG_err_tol: float = 1e-5
    num_mix_comp: int = 10   # decorative in the reference too (SURVEY Q6)
    learn_vars: int = 1
    learn_prior_delay: int = 1
    # truth-free EM stabilizer (beyond-reference): cap the slab's total
    # second moment at N*em_h2_budget after every EM update — Var(y)=1
    # implies h2 <= 1, so a budget just under 1 only ever removes the
    # wide-M/N runaway (engine/linear.py _em_phase).  0 = off (reference
    # trajectory parity, src/vamp.cpp:531-643).
    em_h2_budget: float = 0.0
    alpha_scale: float = 1.0
    redglob: int = 0
    probit_var: float = 1.0
    rho: float = 0.5
    h2: float = 0.5
    gam1: float = 1e-6
    verbosity: int = 0
    iterations: int = 50

    vars: list[float] = field(default_factory=lambda: list(DEFAULT_VARS))
    probs: list[float] = field(default_factory=lambda: list(DEFAULT_PROBS))
    test_iter_range: list[int] = field(default_factory=lambda: [1, 50])

    # extensions (not present in the reference)
    lmmse_solver: str = "auto"    # auto | cg | spectral (ops/spectral.py)
    spectral_max_n: int = 16384   # auto picks spectral only when N <= this
    eigen_cache: str = ""         # persist/reload the once-per-dataset
                                  # eigenbasis (.npz; ops/eigen.py)
    eigen_build_budget: float = 0.0  # wall seconds the eigen build may take
                                  # (0 = unlimited); on overrun the engine
                                  # falls back to the spectral factor path
    compute_dtype: str = "auto"   # auto | float64 | float32 | bfloat16 | int8 | int4
    seed: int = 0                 # seeded probe RNG (fixes reference quirk Q4)
    checkpoint_file: str = ""     # write exact-state .npz after each iteration
    resume_file: str = ""         # resume exactly from a checkpoint .npz
    trace: int = 1                # write <out>_trace.jsonl telemetry
    profile_dir: str = ""         # capture a jax.profiler trace into this dir

    def resolved_compute_dtype(self):
        import jax
        import jax.numpy as jnp

        if self.compute_dtype == "auto":
            # f32 on an accelerator: the passes over X are bound by memory
            # bandwidth, so f32 X moves half the bytes of f64 X (the H100's
            # f64 is native, but bytes set the rate); f64 on the CPU, where
            # the engine doubles as the correctness oracle
            plat = jax.devices()[0].platform
            return jnp.float64 if plat == "cpu" else jnp.float32
        return {
            "float64": jnp.float64,
            "float32": jnp.float32,
            "bfloat16": jnp.bfloat16,
            "f64": jnp.float64,
            "f32": jnp.float32,
            "bf16": jnp.bfloat16,
            # per-marker affine-quantized design matrix (ops/operator.py
            # quantize_markers): 1 byte/element, half of bf16's footprint
            "int8": jnp.int8,
            "i8": jnp.int8,
            # packed 4-bit affine codes, two per byte (ops/operator.py
            # quantize_markers4): 5.4 GB at M=2^20 x N=10240
            "int4": jnp.uint8,
            "i4": jnp.uint8,
        }[self.compute_dtype]

    def check(self):
        if self.meth_file == "" and self.meth_file_test == "":
            raise SystemExit(
                "FATAL  : no meth file provided! Please use the --meth-file option."
            )

    def replace(self, **kw) -> "RunConfig":
        return dataclasses.replace(self, **kw)

    def em_signal_budget(self, n: int) -> float:
        """Internal-scale EM signal budget N*em_h2_budget (prior vars carry
        the xN scaling, vamp.cpp:87-88); 0.0 disables the projection."""
        return float(n) * self.em_h2_budget if self.em_h2_budget > 0 else 0.0

"""vampomi_tpu — gVAMP (EM-flavored Vector Approximate Message Passing)
for omics-scale Bayesian regression on a GPU, in JAX.

Re-designed from scratch (JAX / XLA / jit over a device mesh) with the same
capabilities as the reference MPI/OpenMP C++ implementation
(medical-genomics-group/VAMPomi):

  * linear gVAMP inference with adaptive spike + Gaussian-mixture prior
    (reference: src/vamp.cpp)
  * probit (binary classification) GLM-VAMP (reference: src/vamp_probit.cpp)
  * out-of-sample testing, SE/LOO association testing, probit prediction
    (reference: src/main_meth.cpp, src/main_meth_probit.cpp)
  * marker-sharded distributed execution over a JAX device mesh — the
    equivalent of the reference's MPI column sharding
    (reference: src/utilities.cpp:207-239 divide_work + MPI_Allreduce)

Design notes
------------
The reference fuses column standardization into an elementwise CPU matvec
(src/data.cpp:340-373).  Here the standardized operator

    A = (X - 1 mu^T) diag(1/sigma) / sqrt(N)

is decomposed algebraically into one large matrix product plus a rank-1
correction, so the hot path is one pass over the dense (M, N) matrix.
Cross-device communication is a single psum of an N-vector per A·x —
identical communication volume to the reference's MPI_Allreduce(N).

Scalar bookkeeping (gammas, EM statistics, reductions) is kept in float64;
the M×N design matrix lives in a configurable compute dtype (float32,
bfloat16, int8 or packed int4 on the accelerator; float64 for the CPU
correctness oracle).
"""

import os as _os

import jax as _jax

# Scalar state (gam1/gam2/gamw, EM sufficient statistics, CG reductions) needs
# f64; the hot M×N arrays opt into narrower dtypes explicitly.
_jax.config.update("jax_enable_x64", True)
# Every f32 matrix product runs with full f32 operands.  On a GPU an f32
# dot that states no precision may run in TF32 (~3 decimal digits), which
# the CG reductions, the Gram and the LMMSE solves cannot afford; one global
# setting covers every such dot.  bf16/int8-operand products are unaffected.
_jax.config.update("jax_default_matmul_precision", "highest")

# Persistent compilation cache (see _cachedir): JAX_COMPILATION_CACHE_DIR
# when set, else <repo>/.jax_cache; VAMPOMI_NO_COMPILE_CACHE=1 opts out.
if _os.environ.get("VAMPOMI_NO_COMPILE_CACHE") != "1":
    if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        from ._cachedir import REPO_CACHE_DIR as _REPO_CACHE_DIR

        _jax.config.update("jax_compilation_cache_dir", _REPO_CACHE_DIR)
    _jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

__version__ = "0.1.0"

from . import sharding  # noqa: E402,F401
from . import ops  # noqa: E402,F401
from . import prior  # noqa: E402,F401

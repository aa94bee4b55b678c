"""Checks only a GPU can answer (marker `gpu`; they skip elsewhere).

Run on the card with `VAMPOMI_TEST_GPU=1 python -m pytest tests -m gpu`
(chip_smoke.py's gpu-tests phase does).  They cover what the CPU suite
cannot see: whether f32 products keep full f32 operands (an H100 may run an
f32 dot that states no precision in TF32), whether the exact int8×int8→int32
product of the Gibbs block Grams compiles to cuBLASLt's s8 GEMM and agrees
with the f32 route, and whether the quantized operator routes write a
converted copy of X.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vampomi_tpu.ops.operator import atx_batch, ax_batch
from vampomi_tpu.sim.device_sim import design_from_x, generate_x

pytestmark = pytest.mark.gpu


def test_f32_products_use_full_f32_operands(gpu):
    """The package sets jax_default_matmul_precision=highest: a plain f32
    `@` and the engine's normal-equation operator on an f32 design agree
    with f64 to f32 rounding (TF32 operands would miss by ~1e-3)."""
    from vampomi_tpu.ops.operator import normal_eq_mult

    rng = np.random.default_rng(0)
    a = rng.normal(size=(1024, 2048))
    b = rng.normal(size=(2048, 512))
    got = np.asarray(jnp.asarray(a, jnp.float32) @ jnp.asarray(b, jnp.float32))
    ref = a.astype(np.float32).astype(np.float64) @ b.astype(np.float32)
    assert np.max(np.abs(got - ref)) / np.max(np.abs(ref)) < 1e-5

    X = generate_x(0, 16384, 1024, jnp.float32)
    dm32 = design_from_x(X, 1024)
    dm64 = dm32._replace(X=X.astype(jnp.float64),
                         mave=dm32.mave.astype(jnp.float64),
                         msig=dm32.msig.astype(jnp.float64),
                         mmask=dm32.mmask.astype(jnp.float64),
                         inv_sqrt_n=dm32.inv_sqrt_n.astype(jnp.float64))
    v = jnp.asarray(rng.normal(size=16384))
    got = np.asarray(normal_eq_mult(dm32, v.astype(jnp.float32), 2.0, 0.5))
    ref = np.asarray(normal_eq_mult(dm64, v, 2.0, 0.5))
    assert np.max(np.abs(got - ref)) / np.max(np.abs(ref)) < 1e-5


def test_gibbs_block_grams_s8_gemm(gpu):
    """build_block_grams on int8 X at block=256, N=10240: the exact int8
    product matches int64 arithmetic bit for bit and agrees with the f32
    route on the same codes."""
    from vampomi_tpu.gibbs.sampler import build_block_grams

    n, block = 10240, 256
    X = generate_x(1, 4 * block, n, jnp.int8)
    dm8 = design_from_x(X, n)
    g8 = np.asarray(build_block_grams(dm8, block=block), dtype=np.float64)
    g32 = np.asarray(build_block_grams(dm8._replace(X=X.astype(jnp.float32)),
                                       block=block), dtype=np.float64)
    assert g8.shape == (4, block, block)
    np.testing.assert_allclose(g8, g32, rtol=1e-4, atol=1e-5)

    Xb = np.asarray(X[:block]).astype(np.int64)
    s = jax.lax.dot_general(X[:block], X[:block], (((1,), (1,)), ((), ())),
                            preferred_element_type=jnp.int32)
    np.testing.assert_array_equal(np.asarray(s), Xb @ Xb.T)


@pytest.mark.parametrize("dtype", [jnp.int8, jnp.uint8], ids=["int8", "int4"])
def test_quantized_routes_write_no_converted_copy(gpu, dtype):
    """The reduce direction (operator.reduce_rows) fuses the code convert
    into the reduction: no temp buffer near the size of X.  The broadcast
    direction (bf16 operands at HIGHEST) must not write an f32 copy."""
    m, n = 65536, 10240
    dm = design_from_x(generate_x(2, m, n, dtype), n)
    ys = jax.ShapeDtypeStruct((n, 2), jnp.float32)
    xs = jax.ShapeDtypeStruct((m, 2), jnp.float32)
    temp_atx = jax.jit(atx_batch).lower(dm, ys).compile() \
        .memory_analysis().temp_size_in_bytes
    temp_ax = jax.jit(ax_batch).lower(dm, xs).compile() \
        .memory_analysis().temp_size_in_bytes
    assert temp_atx < 0.1 * m * n
    assert temp_ax < 4 * m * n

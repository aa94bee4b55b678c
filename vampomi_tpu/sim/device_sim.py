"""On-device synthetic designs at the reference's large-scale shape.

An f64 host matrix at N≈1e4 × M≈1e6 (reference simulation/sim_top_iid.py)
is 86 GB, and host quantization (ops/operator.py build_design) would copy it
again.  These generators build X on the device instead, straight into its
marker shards: shard s of a mesh generates its own rows, chunk by chunk, and
chunk c of the global matrix always comes from `fold_in(key, c)`, so the
same (seed, M, N) gives the same matrix on one device or on four.  No RNG
transient exceeds one chunk.

The standardization vectors come from the generated values themselves
(exact integer sums for int8 codes), so the returned DesignMatrix is
standardized exactly like a `build_design` one.  `plant_phenotype` draws a
sparse truth on the host and forms y = A·x + noise from the causal rows
alone, in f64 — independent of the operator under test.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.operator import DesignMatrix
from ..sharding import MARKER_AXIS, make_mesh

CHUNK = 16384


def _chunk_rows(m_local: int) -> int:
    c = min(CHUNK, m_local)
    if m_local % c:
        raise ValueError(f"{m_local} rows per shard is not a multiple of {c}")
    return c


def generate_x(seed: int, m: int, n: int, dtype, mesh: Mesh | None = None):
    """(m, n) X sharded over `mesh`'s marker axis (default: all devices).

    dtype int8: uniform affine codes in [-127, 127]; uint8: packed int4 bytes
    (two uniform nibbles each, (m, n/2)); a float dtype: standard normal."""
    mesh = mesh if mesh is not None else make_mesh()
    ndev = mesh.devices.size
    if m % ndev:
        raise ValueError(f"M={m} does not split over {ndev} devices")
    dtype = jnp.dtype(dtype)
    cols = n // 2 if dtype == jnp.uint8 else n
    m_local = m // ndev
    chunk = _chunk_rows(m_local)
    per_shard = m_local // chunk

    def one_chunk(k):
        if dtype == jnp.int8:
            return jax.random.randint(k, (chunk, cols), -127, 128, dtype=jnp.int8)
        if dtype == jnp.uint8:
            return jax.random.randint(k, (chunk, cols), 0, 256, dtype=jnp.uint8)
        return jax.random.normal(k, (chunk, cols), dtype=dtype)

    @functools.partial(jax.shard_map, mesh=mesh, in_specs=P(),
                       out_specs=P(MARKER_AXIS, None))
    def local(key):
        first = jax.lax.axis_index(MARKER_AXIS) * per_shard
        keys = jax.vmap(lambda c: jax.random.fold_in(key, c))(
            first + jnp.arange(per_shard))
        _, blocks = jax.lax.scan(lambda c, k: (c, one_chunk(k)), 0, keys)
        return blocks.reshape(m_local, cols)

    return jax.jit(local)(jax.random.PRNGKey(seed))


@functools.partial(jax.jit, static_argnames=("n",))
def _row_stats(X, n: int):
    """(mean, 1/sd) per row in f64, sd with the (n-1) denominator (reference
    src/data.cpp:270-276); constant rows get 1/sd = 1."""
    if X.dtype == jnp.uint8:
        p = X.astype(jnp.int32)
        lo, hi = (p & 15) - 8, (p >> 4) - 8
        s1 = (jnp.sum(lo, axis=1) + jnp.sum(hi, axis=1)).astype(jnp.float64)
        s2 = (jnp.sum(lo * lo, axis=1) + jnp.sum(hi * hi, axis=1)).astype(jnp.float64)
    elif X.dtype == jnp.int8:
        # exact: |sum x^2| <= 127^2 n < 2^31 for n < 133k
        xi = X.astype(jnp.int32)
        s1 = jnp.sum(xi, axis=1).astype(jnp.float64)
        s2 = jnp.sum(xi * xi, axis=1).astype(jnp.float64)
    else:
        xf = X.astype(jnp.float64)
        s1 = jnp.sum(xf, axis=1)
        s2 = jnp.sum(xf * xf, axis=1)
    mean = s1 / n
    ss = s2 - s1 * mean
    return mean, jnp.where(ss > 0, jnp.sqrt((n - 1) / jnp.where(ss > 0, ss, 1.0)), 1.0)


def design_from_x(X, n: int) -> DesignMatrix:
    """The standardized operator of an on-device X (no padding: every row is
    a real marker).  Vectors are f32 for the narrow dtypes, else X's dtype."""
    wd = jnp.float32 if X.dtype in (jnp.int8, jnp.uint8, jnp.bfloat16) else X.dtype
    mean, msig = _row_stats(X, n)
    m = X.shape[0]
    vec = X.sharding
    if isinstance(vec, NamedSharding):
        vec = NamedSharding(vec.mesh, P(MARKER_AXIS))
    put = lambda a: jax.device_put(a.astype(wd), vec)  # noqa: E731
    return DesignMatrix(
        X=X,
        mave=put(mean),
        msig=put(msig),
        mmask=put(jnp.ones((m,), wd)),
        inv_sqrt_n=jnp.asarray(1.0 / np.sqrt(float(n)), dtype=wd),
        n=jnp.asarray(float(n), dtype=jnp.float64),
        mt=jnp.asarray(float(m), dtype=jnp.float64),
    )


def plant_phenotype(dm: DesignMatrix, seed: int, lam: float, h2: float):
    """(beta, y): CM = round(M·lam) causal markers with effects N(0, h2/CM)
    (reference simulation/data_sim.py:35-47), y = X_std beta + N(0, 1-h2),
    as host f64 arrays.  X_std beta uses only the CM causal rows, in f64."""
    m = int(dm.mt)
    n = int(dm.n)
    rng = np.random.default_rng(seed)
    cm = max(1, int(round(m * lam)))
    idx = np.sort(rng.choice(m, size=cm, replace=False))
    beta = np.zeros(m)
    beta[idx] = rng.normal(0.0, np.sqrt(h2 / cm), cm)
    rows = jnp.take(dm.X, jnp.asarray(idx), axis=0)
    if rows.dtype == jnp.uint8:
        p = rows.astype(jnp.int32)
        rows = jnp.concatenate([(p & 15) - 8, (p >> 4) - 8], axis=1)
    ii = jnp.asarray(idx)
    std = ((rows.astype(jnp.float64) - dm.mave[ii, None].astype(jnp.float64))
           * dm.msig[ii, None].astype(jnp.float64))
    g = np.asarray(std.T @ jnp.asarray(beta[idx]))
    y = g + rng.normal(0.0, np.sqrt(1.0 - h2), n)
    return beta, y

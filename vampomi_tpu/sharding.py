"""Device-mesh construction and marker ("m" axis) sharding helpers.

Replacement of the reference's MPI work division
(reference: src/utilities.cpp:207-239 `divide_work`): the marker (column)
dimension M is block-partitioned over a 1-D mesh axis ``m`` spanning every
device of every process.  Every GPU of a host reaches every other at the
same rate (NVLink), so the mesh follows the algorithm alone.  N-length sample vectors stay replicated, which
mirrors the reference's "all individuals on every rank" layout
(reference: src/data.cpp:295,342).

All cross-device communication is XLA-inserted: an einsum contracting the
sharded M axis lowers to a local contraction + all-reduce — the same
communication pattern (and volume) as the reference's
`MPI_Allreduce(length N)` in `data::Ax` (src/data.cpp:367).
"""

from __future__ import annotations

import math
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

MARKER_AXIS = "m"


def make_mesh(devices: Sequence[jax.Device] | None = None) -> Mesh:
    """Build a 1-D mesh over the marker axis using all available devices."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (MARKER_AXIS,))


def marker_sharding(mesh: Mesh, ndim: int = 1) -> NamedSharding:
    """Sharding for an array whose leading dim is the marker dim M."""
    spec = P(MARKER_AXIS, *([None] * (ndim - 1)))
    return NamedSharding(mesh, spec)


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def divide_work(Mt: int, nranks: int) -> list[tuple[int, int]]:
    """Block-partition Mt markers over `nranks` workers.

    Same arithmetic as the reference so that multi-host file slabs and output
    offsets match byte-for-byte (reference: src/utilities.cpp:207-239):
    remainder markers go to the first ``Mt % nranks`` workers.

    Returns a list of (M, S) = (local count, global start) per worker.
    """
    size = Mt // nranks
    modu = Mt % nranks
    out = []
    cum = 0
    for i in range(nranks):
        m = size + 1 if i < modu else size
        out.append((m, cum))
        cum += m
    assert cum == Mt
    return out


def pad_to_multiple(n: int, mult: int) -> int:
    return ((n + mult - 1) // mult) * mult


def distribute(arr, mesh: Mesh, spec: P):
    """Place a host array onto the mesh with the given partition spec.

    Single-process path: `jax.device_put` with a NamedSharding.  In a
    multi-host program each process should instead build the global array
    from its local slab via `jax.make_array_from_process_local_data`; this
    helper dispatches on process count.
    """
    sharding = NamedSharding(mesh, spec)
    if jax.process_count() == 1:
        return jax.device_put(arr, sharding)
    return jax.make_array_from_process_local_data(sharding, np.asarray(arr))


def commit_like(like, marker=(), replicated=()):
    """Place loop state the way the engines' jitted phases return it on
    `like`'s mesh: the `marker` trees over the marker axis, the
    `replicated` trees on every device.  Host or uncommitted initial values
    would otherwise give iteration 1 different argument shardings than
    iteration 2 (which feeds back phase outputs), and every phase would
    compile twice.  Returns (marker, replicated); unchanged off a mesh."""
    sh = getattr(like, "sharding", None)
    if not isinstance(sh, NamedSharding):
        return marker, replicated

    def put(spec):
        target = NamedSharding(sh.mesh, spec)
        return lambda a: jax.device_put(jnp.asarray(a), target)

    return (jax.tree.map(put(P(MARKER_AXIS)), marker),
            jax.tree.map(put(P()), replicated))


def padded_marker_count(Mt: int, mesh: Mesh, tile: int = 1) -> int:
    """Global marker count padded so it divides evenly over the mesh and the
    requested tile size (XLA wants static, evenly divisible shards)."""
    n_dev = math.prod(mesh.devices.shape)
    return pad_to_multiple(Mt, n_dev * tile)


def fetch_global(arr) -> np.ndarray:
    """Fetch a (possibly multi-host sharded) jax array to a full host copy.

    Single-process arrays are fully addressable and fetch directly; across
    processes the shards are all-gathered first (the artifact-file analog of
    the reference's per-rank shared-file writes, src/utilities.cpp:241-249 —
    a per-host slab-write optimization can replace this later without
    changing the file bytes).
    """
    import jax

    if getattr(arr, "is_fully_addressable", True):
        return np.asarray(jax.device_get(arr))
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.process_allgather(arr, tiled=True))


def local_slab(arr):
    """(start, block) — this process's contiguous rows of a 1-D
    marker-sharded global array (our layout gives each process one
    contiguous block; see dataset.load_dataset).  Works single-process too
    (start=0, full array)."""
    shards = sorted(
        arr.addressable_shards,
        key=lambda s: (s.index[0].start or 0) if s.index else 0,
    )
    start = (shards[0].index[0].start or 0) if shards[0].index else 0
    block = np.concatenate([np.asarray(s.data) for s in shards])
    return start, block

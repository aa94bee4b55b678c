"""Binary vector/matrix IO matching the reference's byte formats.

Formats (reference: SURVEY §2.4):
  * meth `.bin`   — Mt consecutive marker blocks of N float64 each
                    (marker-major; reference simulation/data_sim.py:58,
                    slab offset math src/data.cpp:134)
  * vector `.bin` — Mt float64 (estimates, r1, true signals, p-values;
                    reference src/utilities.cpp:241-267)

Each host reads/writes only its own slab of the single shared file — the
equivalent of the reference's `MPI_File_set_view` at offset S·8
(src/utilities.cpp:246,258).
"""

from __future__ import annotations

import os

import numpy as np

try:  # native IO runtime (threaded pread/pwrite, fused f64->f32 ingest)
    from .. import _native
except ImportError:  # pure-python fallback; build with `python setup.py build_ext --inplace`
    _native = None


def read_bin_slab(path: str, count: int, start: int = 0) -> np.ndarray:
    """Read `count` float64 values starting at element offset `start`.
    Mirrors `mpi_read_vec_from_file` (src/utilities.cpp:251-267).

    A short read is fatal (the reference asserts the MPI-IO byte count,
    src/utilities.cpp:373-381): truncated estimate/r1/true-signal inputs must
    never silently flow into the engine as shorter vectors."""
    if _native is not None:
        out = np.empty(count, dtype="<f8")
        _native.read_into(path, memoryview(out), start * 8)  # errors on EOF
        return out
    out = np.fromfile(path, dtype="<f8", count=count, offset=start * 8)
    if out.size != count:
        raise ValueError(
            f"{path}: expected {count} float64 at element offset {start} "
            f"but the file holds only {out.size} past it "
            f"(file size {os.path.getsize(path)} bytes)"
        )
    return out


def write_bin_slab(path: str, vec: np.ndarray, start: int = 0) -> None:
    """Write float64 `vec` at element offset `start`, creating the file if
    needed.  Mirrors `mpi_store_vec_to_file` (src/utilities.cpp:241-249):
    concurrent hosts each write disjoint slabs of one shared file."""
    vec = np.ascontiguousarray(vec, dtype="<f8")
    if _native is not None:
        _native.write_from(path, memoryview(vec).cast("B"), start * 8)
        return
    # O_CREAT WITHOUT O_TRUNC + pwrite: concurrent hosts writing disjoint
    # slabs of one shared file must never truncate each other (the native
    # path already opens this way)
    fd = os.open(path, os.O_CREAT | os.O_WRONLY, 0o644)
    try:
        os.pwrite(fd, vec.tobytes(), start * 8)
    finally:
        os.close(fd)


def _check_meth_size(path: str, n: int, m: int, start_marker: int) -> int:
    """Guard against truncated / wrong-shape meth files up front with a clear
    message (the reference asserts byte counts after the collective read,
    src/utilities.cpp:38-46, 373-381; np.memmap's own error is opaque).
    Returns the byte offset of the slab."""
    offset = start_marker * n * 8
    need = offset + m * n * 8
    size = os.path.getsize(path)
    if size < need:
        raise ValueError(
            f"{path}: meth file too small — need {need} bytes for markers "
            f"[{start_marker}, {start_marker + m}) x N={n} float64, file has "
            f"{size} (is N or the marker count wrong?)"
        )
    return offset


def read_meth_bin(
    path: str, n: int, m: int, start_marker: int = 0, dtype=np.float64
) -> np.ndarray:
    """Load `m` markers starting at `start_marker` of the marker-major meth
    matrix as an (m, n) array.

    Mirrors the reference's collective slab read at byte offset S·N·8
    (src/data.cpp:116-153) without ever loading other hosts' slabs.  With the
    native runtime and a float32 target, the f64 file data is narrowed
    in-flight — no full-size f64 temporary.
    """
    dt = np.dtype(dtype)
    offset = _check_meth_size(path, n, m, start_marker)
    if _native is not None:
        if dt == np.float32:
            out = np.empty((m, n), dtype=np.float32)
            _native.read_f64_as_f32(path, memoryview(out.reshape(-1)), offset)
            return out
        if dt == np.float64:
            out = np.empty((m, n), dtype="<f8")
            _native.read_into(path, memoryview(out.reshape(-1)), offset)
            return out
    mm = np.memmap(path, dtype="<f8", mode="r", shape=(m, n), offset=offset)
    return np.asarray(mm, dtype=dt)


def read_meth_bin_stats(
    path: str, n: int, m: int, start_marker: int = 0
) -> tuple[np.ndarray, np.ndarray, np.ndarray] | None:
    """Fused load: (m, n) float32 slab PLUS per-marker f64 (mean, centered
    sum of squares), computed in the same threaded pass over the f64 file.

    The reference computes marker statistics in a separate native pass after
    the collective read (src/data.cpp:233-283, OpenMP+SIMD); fusing them into
    the ingest means the matrix is never re-read from host memory.  Returns
    None when the native runtime is unavailable (callers fall back to
    read_meth_bin + numpy statistics).
    """
    if _native is None or not hasattr(_native, "read_f64_as_f32_stats"):
        return None
    offset = _check_meth_size(path, n, m, start_marker)
    X = np.empty((m, n), dtype=np.float32)
    mave = np.empty(m, dtype=np.float64)
    sumsq = np.empty(m, dtype=np.float64)
    _native.read_f64_as_f32_stats(
        path, memoryview(X.reshape(-1)), offset, n,
        memoryview(mave), memoryview(sumsq),
    )
    return X, mave, sumsq


def read_vec_from_text(path: str, count: int, start: int = 0) -> np.ndarray:
    """Whitespace-separated text vector window [start, start+count)
    (reference src/utilities.cpp:104-122)."""
    vals = []
    it = 0
    with open(path) as f:
        for tok in f.read().split():
            if start <= it < start + count:
                vals.append(float(tok))
            elif it >= start + count:
                break
            it += 1
    if len(vals) != count:
        raise ValueError(
            f"{path}: expected {count} values from position {start} but the "
            f"file holds only {len(vals)} past it"
        )
    return np.asarray(vals, dtype=np.float64)


def iteration_file(out_dir: str, out_name: str, it: int, kind: str = "") -> str:
    """Output naming contract: `<out>_it_<k>.bin`, `<out>_r1_it_<k>.bin`, …
    The `it_<k>` substring is load-bearing — downstream modes parse the
    iteration number back out of the filename (src/main_meth.cpp:151-166)."""
    prefix = f"{out_name}_{kind}it_{it}" if kind else f"{out_name}_it_{it}"
    return os.path.join(out_dir, prefix + ".bin")


def substitute_iteration(file_name: str, it: int) -> str:
    """Rewrite `..._it_<k>.<ext>` to iteration `it`, replicating the
    substring surgery in the reference test mode (src/main_meth.cpp:150-166):
    everything from the last "it" through the first "." is replaced.  The
    surgery is scoped to the BASENAME so dotted directory components
    ("./out", "results.v2/") don't corrupt the path (the reference operates
    on the raw argv string and has no such protection)."""
    head, base = os.path.split(file_name)
    pos_it = base.rfind("it")
    if pos_it < 0:
        raise ValueError(
            f"estimate/r1 filename must contain an 'it_<k>' tag: {file_name!r}"
        )
    ext = base[base.find(".") + 1 :]
    return os.path.join(head, base[:pos_it] + f"it_{it}." + ext)


def parse_iteration(file_name: str) -> str:
    """Extract the iteration substring between the last 'it_' and '.bin'
    (reference src/main_meth.cpp:222-226, 247-251)."""
    base = os.path.basename(file_name)
    pos1 = base.rfind("it_")
    if pos1 < 0:
        raise ValueError(
            f"filename must contain an 'it_<k>' tag: {file_name!r}"
        )
    return base[pos1 + 3 : base.rfind(".bin")]


def write_marker_file(path: str, arr_dev, mt: int, divisor: float) -> None:
    """Write a (possibly multi-host sharded) padded M-vector to the shared
    f64 artifact file, divided by `divisor` (division, not reciprocal
    multiplication, for bit parity with the reference's x/sqrt(N),
    src/vamp.cpp:237-239), truncated to the Mt real markers.

    Multi-host: each process pwrites only its own contiguous marker slab at
    byte offset start*8 — the POSIX analog of the reference's per-rank
    MPI_File_set_view writes (src/utilities.cpp:241-249); bytes on disk are
    identical to a single-process write.
    """
    import jax

    from ..sharding import local_slab

    if getattr(arr_dev, "is_fully_addressable", True) and jax.process_count() == 1:
        vec = np.asarray(jax.device_get(arr_dev), dtype=np.float64)[:mt] / divisor
        write_bin_slab(path, vec)
        return
    start, block = local_slab(arr_dev)
    hi = min(start + len(block), mt)
    if start >= mt:
        return
    vec = np.asarray(block[: hi - start], dtype=np.float64) / divisor
    write_bin_slab(path, vec, start=start)

"""Background device→host artifact pipeline.

Per-iteration artifact dumps (the reference writes x1_hat/√N and r1/√N every
iteration, src/vamp.cpp:234-252, plus our exact-state checkpoints) require a
device→host fetch of M-length vectors and a file write (16 MB per iteration
at M ~ 1e6).  A single worker thread performs the fetch + file write while
the main thread dispatches the next iteration (jax arrays are immutable and
fetches are thread-safe), so artifact IO overlaps compute.  Whether the
overlap still pays on the GPU is not measured yet.

One worker preserves write order; exceptions surface on the next submit or
at flush().
"""

from __future__ import annotations

from concurrent.futures import Future, ThreadPoolExecutor


class AsyncWriter:
    def __init__(self, max_pending: int = 4):
        self._ex = ThreadPoolExecutor(max_workers=1, thread_name_prefix="artifact-io")
        self._pending: list[Future] = []
        self._max_pending = max_pending

    def submit(self, fn, *args, **kwargs) -> None:
        # single snapshot: a future completing between two done() sweeps must
        # not be dropped unchecked (its exception would be swallowed)
        snapshot = self._pending
        done = [f for f in snapshot if f.done()]
        self._pending = [f for f in snapshot if f not in done]
        for f in done:
            f.result()  # surface failures from finished work
        # backpressure: the queue holds references to per-iteration device
        # buffers — an unbounded backlog would pin device memory until close()
        while len(self._pending) >= self._max_pending:
            self._pending.pop(0).result()
        self._pending.append(self._ex.submit(fn, *args, **kwargs))

    def flush(self) -> None:
        """Block until all queued writes are durably on disk; re-raise errors."""
        pending, self._pending = self._pending, []
        for f in pending:
            f.result()

    def close(self) -> None:
        try:
            self.flush()
        finally:
            # always reap the worker thread, even when flush re-raises (the
            # drivers call close() in finally blocks — a leaked thread or a
            # masked primary exception would be worse than the IO error)
            self._ex.shutdown(wait=True)

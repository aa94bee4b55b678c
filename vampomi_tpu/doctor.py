"""Environment health check: `python -m vampomi_tpu.doctor`.

The reference assumes a healthy MPI cluster and fails mid-run when it is not
(MPI_Abort in check_mpi, src/utilities.cpp:21-35).  Here the failure
surface is different — a device that does not answer hangs the first
computation, a cold compilation cache turns a short start into minutes, a
missing native extension silently halves ingest throughput — so this module
probes each dependency UP FRONT with timeouts and prints one PASS/WARN/FAIL
line per check.  Exit code 0 = all PASS/WARN, 1 = any FAIL.

The doctor process itself never initializes a JAX backend: the device probe
runs in a child under a deadline (a hung device reports "FAIL (hang)"
instead of hanging the doctor), and the math check runs in a CPU-forced
child.  So the doctor can run beside a job that holds the GPU, and its
probe is the only process it adds to the card.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

_GREEN, _YELLOW, _RED, _OFF = "\033[32m", "\033[33m", "\033[31m", "\033[0m"


def _line(status: str, name: str, detail: str) -> bool:
    color = {"PASS": _GREEN, "WARN": _YELLOW, "FAIL": _RED}[status]
    tty = sys.stdout.isatty()
    tag = f"{color}{status}{_OFF}" if tty else status
    print(f"[{tag}] {name:<22} {detail}")
    return status != "FAIL"


def check_python_deps() -> bool:
    missing = []
    for mod in ("jax", "numpy", "scipy"):
        try:
            __import__(mod)
        except ImportError:
            missing.append(mod)
    if missing:
        return _line("FAIL", "python deps", f"missing: {', '.join(missing)}")
    import jax

    return _line("PASS", "python deps", f"jax {jax.__version__}")


def check_native_ext() -> bool:
    try:
        from vampomi_tpu.io import bin_io

        ok = bin_io._native is not None
    except Exception:
        ok = False
    if ok:
        return _line("PASS", "native extension", "_native loaded (fused ingest)")
    return _line("WARN", "native extension",
                 "not built — pure-numpy ingest fallback "
                 "(python setup.py build_ext --inplace)")


def check_compile_cache() -> bool:
    from vampomi_tpu._cachedir import cache_dir

    path = cache_dir()
    if path is None:
        return _line("WARN", "compile cache", "disabled by env")
    n = 0
    if os.path.isdir(path):
        try:
            n = len(os.listdir(path))
        except OSError:
            pass
    else:
        try:
            os.makedirs(path, exist_ok=True)
        except OSError:
            return _line("FAIL", "compile cache", f"{path} not writable")
    warmth = f"{n} cached executables" if n else "cold (first run compiles)"
    # the persistent-cache key includes the cache dir path itself: pointing
    # JAX_COMPILATION_CACHE_DIR somewhere new makes every prior entry a miss
    return _line("PASS", "compile cache", f"{path} — {warmth}")


def _probe(code: str, timeout_s: float, env: dict | None = None):
    """Run `code` in a fresh interpreter under a deadline; None on timeout."""
    try:
        return subprocess.run(
            [sys.executable, "-c", code], capture_output=True, text=True,
            timeout=timeout_s, env=env,
        )
    except subprocess.TimeoutExpired:
        return None


_DEVICE_PROBE = (
    "import jax, jax.numpy as jnp, time\n"
    "d = jax.devices()\n"
    "t0 = time.time()\n"
    "x = jnp.ones((512, 512))\n"
    "v = float((x @ x)[0, 0])\n"
    "print(f'{d[0].platform}|{d[0].device_kind}|{len(d)}|{v:.0f}|"
    "{time.time()-t0:.2f}')\n"
)


def device_line(stdout: str, wall_s: float) -> tuple[str, str]:
    """(status, detail) of the device check from the probe's output line
    `platform|device_kind|count|matmul value|matmul seconds`."""
    plat, kind, ndev, val, dt = stdout.strip().splitlines()[-1].split("|")
    if val != "512":
        return "FAIL", f"matmul returned {val}, expected 512"
    detail = (f"{ndev}x {plat} ({kind}), 512x512 matmul in {dt}s "
              f"(wall {wall_s:.1f}s)")
    if plat == "cpu":
        return "WARN", detail + " — no accelerator visible"
    return "PASS", detail


def check_device(timeout_s: float = 60.0) -> bool:
    """Probe the accelerator in a SUBPROCESS under a deadline: a device
    that never answers must become a FAIL line rather than a hung doctor.
    The child takes only a small share of the card's memory, so the probe
    fits beside a job that already holds it."""
    t0 = time.time()
    env = dict(os.environ, XLA_PYTHON_CLIENT_MEM_FRACTION="0.05")
    out = _probe(_DEVICE_PROBE, timeout_s, env=env)
    if out is None:
        return _line("FAIL", "device", f"hang: no matmul within {timeout_s:.0f}s")
    if out.returncode != 0:
        tail = (out.stderr or "").strip().splitlines()
        return _line("FAIL", "device", tail[-1] if tail else "probe crashed")
    status, detail = device_line(out.stdout, time.time() - t0)
    return _line(status, "device", detail)


def check_math(timeout_s: float = 120.0) -> bool:
    """erfcx vs the scipy oracle, in a CPU-forced subprocess — in-process
    jnp math would initialize the default accelerator in the doctor
    itself, and hang with it when the device does not answer."""
    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        f"import sys; sys.path.insert(0, {pkg_root!r})\n"
        "import os; os.environ['JAX_PLATFORMS'] = 'cpu'\n"
        "import jax; jax.config.update('jax_platforms', 'cpu')\n"
        "import numpy as np, jax.numpy as jnp\n"
        "from scipy.special import erfcx as ref\n"
        "from vampomi_tpu.utils.mathx import erfcx\n"
        "x = np.array([0.0, 1.0, 5.0, 20.0])\n"
        "ok = np.allclose(np.asarray(erfcx(jnp.asarray(x))), ref(x), rtol=1e-10)\n"
        "print('MATH_OK' if ok else 'MATH_BAD')\n"
    )
    out = _probe(code, timeout_s)
    if out is None:
        return _line("FAIL", "math kernels", "probe timed out")
    if out.returncode == 0 and "MATH_OK" in out.stdout:
        return _line("PASS", "math kernels", "erfcx matches the scipy oracle")
    tail = (out.stderr or out.stdout).strip().splitlines()
    return _line("FAIL", "math kernels", tail[-1] if tail else "mismatch")


def main(argv: list[str] | None = None) -> int:
    timeout = 60.0
    args = sys.argv[1:] if argv is None else argv
    if args and args[0] == "--device-timeout":
        timeout = float(args[1])
    ok = True
    ok &= check_python_deps()
    ok &= check_native_ext()
    ok &= check_compile_cache()
    ok &= check_math()
    ok &= check_device(timeout)
    print("doctor:", "healthy" if ok else "PROBLEMS FOUND")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

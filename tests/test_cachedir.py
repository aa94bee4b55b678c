"""Compile-cache placement (vampomi_tpu/_cachedir.py, vampomi_tpu/__init__.py):
JAX_COMPILATION_CACHE_DIR wins and the package sets no other directory;
otherwise one fixed path inside the checkout, the same in every process."""

import os
import subprocess
import sys

from vampomi_tpu import _cachedir

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = (
    "import jax, vampomi_tpu, vampomi_tpu._cachedir as c\n"
    "print(jax.config.jax_compilation_cache_dir, c.cache_dir(), sep='|')\n"
)


def _probe(**env):
    base = {k: v for k, v in os.environ.items()
            if k not in ("JAX_COMPILATION_CACHE_DIR", "VAMPOMI_NO_COMPILE_CACHE")}
    out = subprocess.run([sys.executable, "-c", PROBE], env={**base, **env},
                         capture_output=True, text=True, timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout.strip().splitlines()[-1].split("|")


def test_env_var_is_honoured_and_nothing_else_set(tmp_path):
    configured, reported = _probe(JAX_COMPILATION_CACHE_DIR=str(tmp_path))
    assert configured == str(tmp_path) and reported == str(tmp_path)


def test_default_is_one_fixed_path_in_the_checkout(tmp_path):
    a = _probe(TMPDIR=str(tmp_path / "a"), HOME=str(tmp_path))
    b = _probe(TMPDIR="/nonexistent-tmp")
    assert a == b == [_cachedir.REPO_CACHE_DIR] * 2
    assert _cachedir.REPO_CACHE_DIR == os.path.join(REPO, ".jax_cache")
    # no uid, pid, temp dir or host fingerprint in the key's path
    assert str(os.getuid()) not in os.path.basename(_cachedir.REPO_CACHE_DIR)
    ignored = open(os.path.join(REPO, ".gitignore")).read().split()
    assert ".jax_cache/" in ignored


def test_opt_out_disables_the_cache(monkeypatch):
    configured, reported = _probe(VAMPOMI_NO_COMPILE_CACHE="1")
    assert reported == "None" and configured in ("None", "")
    monkeypatch.setenv("VAMPOMI_NO_COMPILE_CACHE", "1")
    assert _cachedir.cache_dir() is None

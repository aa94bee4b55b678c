"""Persistent compilation-cache directory (jax-free helper).

`JAX_COMPILATION_CACHE_DIR`, when set, is JAX's own setting and wins: the
package then configures no directory of its own.  Otherwise the cache lives
at one fixed path inside the checkout, `<repo>/.jax_cache` (gitignored).
The directory is part of JAX's cache key, so the default carries no user,
temp dir, process, time or host component: a fresh machine running the same
checkout looks up the same entries.  `VAMPOMI_NO_COMPILE_CACHE=1` turns the
package's cache off.  Kept import-light (no jax) so doctor.py can report the
path without initializing a backend.
"""

from __future__ import annotations

import os

REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)


def cache_dir() -> str | None:
    """The compile-cache directory in use, or None when disabled."""
    if os.environ.get("VAMPOMI_NO_COMPILE_CACHE") == "1":
        return None
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or REPO_CACHE_DIR

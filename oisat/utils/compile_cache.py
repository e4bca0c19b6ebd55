"""JAX's persistent compilation cache at one fixed place.

Entry points (``run/job.py``, ``run/campaign.py``, ``bench.py``,
``chip_smoke.py``) call :func:`enable_compile_cache` before their first
compile.  ``JAX_COMPILATION_CACHE_DIR``, when set, names the directory and
nothing else is set.  Otherwise the cache lives in ``<repo>/.jax_cache``
(listed in ``.gitignore``): a fixed path, because the path is part of what
a later process must find again — a temp-, pid- or time-derived directory
would never hit.
"""

from __future__ import annotations

import os
from pathlib import Path

__all__ = ["DEFAULT_CACHE_DIR", "enable_compile_cache"]

DEFAULT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory and return
    that directory."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(DEFAULT_CACHE_DIR)
    jax.config.update("jax_compilation_cache_dir", path)
    return path

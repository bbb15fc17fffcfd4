"""Persistent XLA compilation cache.

Compiling the fused progressive renderer and the differentiable training
step costs seconds to minutes; a disk cache keyed by program hash lets every
later process with the same programs start at once.  The reference app pays
an analogous cost in GLSL compilation each launch and does not cache
(src/Render/Objects/ShaderProgram.cs:22-27).

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX keeps the cache there by
itself and nothing here overrides it.  Otherwise the cache lives at a fixed
path inside the checkout (``<repo>/.jax_cache``, ignored by git): the path
takes part in the cache key, so a directory that moved would never hit.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def cache_dir() -> str:
    """Where the compilation cache lives for this process."""
    return os.environ.get(ENV_VAR) or REPO_CACHE_DIR


def enable_persistent_cache() -> str:
    """Turn the on-disk compilation cache on and return its directory."""
    if os.environ.get(ENV_VAR):
        return os.environ[ENV_VAR]
    import jax

    os.makedirs(REPO_CACHE_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", REPO_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)
    return REPO_CACHE_DIR

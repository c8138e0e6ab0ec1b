"""Persistent XLA compilation cache setup.

Large programs (a full filter scan) take a long time to compile; the
persistent cache makes repeat runs of the workloads/bench start in
seconds. When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself
and nothing is set here. Otherwise the cache lives at a fixed path inside
the checkout (``<checkout>/.jax_cache``): the path is part of the cache
key, so a directory that moves never hits. Call before the first jit
execution.
"""

from __future__ import annotations

import os

import jax

DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))),
    ".jax_cache",
)


def enable_compilation_cache(min_compile_time_secs: float = 0.5) -> None:
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      min_compile_time_secs)

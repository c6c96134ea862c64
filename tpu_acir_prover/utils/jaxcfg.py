"""Central JAX configuration: persistent compilation cache and x64.

The prover compiles O(log n) distinct XLA programs per circuit shape
(Merkle levels, FRI layers), and a cold prove spends most of its set-up
time in the compiler.  The persistent cache (keyed by HLO hash) makes
every compile a one-time cost across *processes*: prime once, then every
CLI invocation / bench run / test reuses the on-disk executable.

The reference has no analog (its Rust plonky2 fork compiles nothing at
runtime); this is the replacement for "the circuit is a static Rust
binary".
"""

from __future__ import annotations

import os

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_DONE = False


def cache_dir(environ=os.environ):
    """The compile-cache directory this package sets, or None when
    JAX_COMPILATION_CACHE_DIR is set (JAX reads that variable itself)."""
    if environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return os.path.join(_REPO, ".jax_cache")


def setup_jax_cache() -> None:
    """Enable JAX's persistent compilation cache (idempotent)."""
    global _DONE
    if _DONE:
        return
    _DONE = True
    import jax
    path = cache_dir()
    if path is not None:
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)


def setup_jax() -> None:
    """Full JAX setup for prover entry points: persistent compile cache +
    x64, so the field runs in native uint64 (field/gl.py uses_u64)."""
    setup_jax_cache()
    import jax
    jax.config.update("jax_enable_x64", True)

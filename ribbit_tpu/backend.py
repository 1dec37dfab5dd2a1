"""Backend selection and device start-up.

The reference is CPU-only (ribbit.cpp:180-297).  ribbit-tpu adds one
device path (--backend device): event extraction on the accelerator
through XLA (scan_events_tpu), then the native host replay and threaded
refinement (csrc/ribbit_core.c, csrc/ribbit_refine.c).  Its output is
byte-identical to --backend host.

`auto` (the default) resolves to `device` exactly when JAX's default
backend is a GPU, and to `host` otherwise; RIBBIT_BACKEND=host|device
overrides it.  The choice is printed and cached per process.

An explicit `device` runs on whatever JAX platform the process has (the
GPU on a card, the CPU in the tests).  Nothing here falls back: a platform
that does not initialise is an error for the caller to report.
"""

from __future__ import annotations

import os
import sys
from typing import Optional

from .native import _BUILD

_cached: Optional[str] = None


def _default_platform() -> Optional[str]:
    """JAX's default backend name, or None when JAX is absent or its
    platform does not initialise."""
    try:
        import jax
        return jax.default_backend()
    except (ImportError, RuntimeError):
        return None


def gpu_present() -> bool:
    """The one device predicate: JAX's default backend is a GPU."""
    return _default_platform() == "gpu"


def resolve_backend(requested: str = "auto", quiet: bool = False) -> str:
    """Resolve 'auto' to 'host' or 'device'; pass explicit choices through."""
    global _cached
    if requested != "auto":
        return requested
    env = os.environ.get("RIBBIT_BACKEND", "").strip().lower()
    if env in ("host", "device"):
        return env
    if _cached is None:
        _cached = "device" if gpu_present() else "host"
        if not quiet:
            print(f"ribbit-tpu: backend auto -> {_cached} "
                  f"(JAX platform: {_default_platform()})", file=sys.stderr)
    return _cached


def compile_cache_dir() -> str:
    """Where the device path keeps JAX's persistent compilation cache:
    JAX_COMPILATION_CACHE_DIR when set, else build/jax_cache in the
    checkout (a fixed path: the directory is part of the cache key)."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(
        _BUILD / "jax_cache")


def start_device() -> str:
    """Bring up JAX for the device path and return its platform name.

    Points the persistent compilation cache at compile_cache_dir() unless
    JAX_COMPILATION_CACHE_DIR is set (JAX reads that variable itself).
    Raises RuntimeError when the platform does not initialise."""
    import jax
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", compile_cache_dir())
    return jax.default_backend()

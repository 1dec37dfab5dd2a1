"""ctypes bindings for the native C runtime (csrc/).

The shared object is compiled on demand with the system compiler and cached
under build/ keyed by a source hash, so `pip install`-style steps aren't
needed.  Falls back cleanly (returns None) when no compiler is available;
callers then use the pure-Python paths.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess

_REPO = pathlib.Path(__file__).resolve().parent.parent
_CSRC = _REPO / "csrc"
_BUILD = _REPO / "build"

_lib = None
_tried = False


def _compile(src) -> pathlib.Path | None:
    """Compile one source file or a list of sources into one cached .so."""
    srcs = [src] if isinstance(src, pathlib.Path) else list(src)
    h = hashlib.sha256(b"".join(s.read_bytes() for s in srcs)).hexdigest()[:16]
    out = _BUILD / f"{srcs[0].stem}_{h}.so"
    if out.exists():
        return out
    _BUILD.mkdir(exist_ok=True)
    for cc in ("cc", "gcc", "clang"):
        try:
            r = subprocess.run(
                [cc, "-O3", "-march=native", "-shared", "-fPIC", "-pthread"]
                + [str(s) for s in srcs] + ["-o", str(out), "-lm"],
                capture_output=True, timeout=120)
            if r.returncode == 0 and out.exists():
                return out
        except (OSError, subprocess.TimeoutExpired):
            continue
    return None


def get_align_lib():
    """Native aligner entry from the combined library; None if unavailable."""
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    if os.environ.get("RIBBIT_NO_NATIVE"):
        return None
    from .core import get_core_lib
    base = get_core_lib()
    if base is None:
        return None
    base.ribbit_align.restype = ctypes.c_int
    base.ribbit_align.argtypes = [
        ctypes.POINTER(ctypes.c_int8), ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int8), ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_char_p, ctypes.c_int32,
    ]
    _lib = base
    return _lib


_vote_lib = None
_vote_tried = False


def get_vote_lib():
    """Native diagonal-voting entry from the combined library."""
    global _vote_lib, _vote_tried
    if _vote_tried:
        return _vote_lib
    _vote_tried = True
    if os.environ.get("RIBBIT_NO_NATIVE"):
        return None
    from .core import get_core_lib
    base = get_core_lib()
    if base is None:
        return None
    base.ribbit_vote_longer.restype = ctypes.c_int32
    base.ribbit_vote_longer.argtypes = [
        ctypes.POINTER(ctypes.c_int8), ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
    ]
    base.ribbit_vote_prefix_batch.restype = None
    base.ribbit_vote_prefix_batch.argtypes = [
        ctypes.POINTER(ctypes.c_int8), ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32),
    ]
    _vote_lib = base
    return _vote_lib

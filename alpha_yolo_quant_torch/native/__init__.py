"""Native (C++) host components, loaded with ctypes, with Python fallbacks.
Currently: the Verilog artifact emitter (fastwriter.cpp, a copy of the JAX
package's, so both write the same bytes).

The library is built with ``g++`` on first use into ``native/build/``
(listed in .gitignore), named by a hash of the source and flags, so an
edit rebuilds and an unchanged tree reuses what is there. Without a
toolchain ``fastwriter()`` returns None and export/verilog.py writes the
same text in Python.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional

_DIR = Path(__file__).resolve().parent
SRC = _DIR / "fastwriter.cpp"
BUILD_DIR = _DIR / "build"
FLAGS = ["-O2", "-shared", "-fPIC"]
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _target() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode() + SRC.read_bytes())
    return BUILD_DIR / f"libfastwriter_{h.hexdigest()[:16]}.so"


def _build(so: Path) -> bool:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *FLAGS, str(SRC), "-o", str(tmp)],
                       check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return False
    # atomic: a concurrent build never loads half a file
    os.replace(tmp, so)
    return True


def fastwriter() -> Optional[ctypes.CDLL]:
    """Load (building on first use) the native emitter; None when no
    toolchain is available: callers fall back to the Python writers."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    so = _target()
    if not so.exists() and not _build(so):
        return None
    try:
        lib = ctypes.CDLL(str(so))
    except OSError:
        return None
    lib.write_txt_activations.restype = ctypes.c_int
    lib.write_txt_activations.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int]
    lib.write_txt_weights.restype = ctypes.c_int
    lib.write_txt_weights.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_long, ctypes.c_int,
        ctypes.c_int]
    _lib = lib
    return _lib

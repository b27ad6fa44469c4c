"""Build and load the Hopper kernels (runtime/csrc/*.cu).

Each source is compiled by ``nvcc`` into its own shared library with a
plain C interface and loaded with ``ctypes``; all sources compile at once,
one ``nvcc`` process each. Libraries go to ``runtime/build/`` (listed in
.gitignore), named by a hash of every source, header and flag, so an edit
rebuilds and an unchanged tree reuses what is there. Nothing here runs at
import time: the first wrapper call on a CUDA tensor triggers the build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
SOURCES = ("conv1x1", "conv3x3", "sigma_probe", "postconv", "packed_conv",
           "glue", "dwconv", "attn")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_U = ctypes.c_uint
_PP, _PI = ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int)
_PL = ctypes.POINTER(ctypes.c_longlong)
# C signatures (runtime/csrc/*.cu): every device pointer and the stream as
# c_void_p; host arrays (the slab conv's slabs and launch plan, the glue
# kernel's parts) as pointer types
ARGTYPES = {
    "ayq_conv1x1": [_P, _I, _P, _P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _P,
                    _I, _I, _I, _I, _I, _I, _I, _P],
    "ayq_conv3x3": [_P, _I, _P, _P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _P,
                    _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "ayq_conv_weight_map": [_P, _I, _I, _I, _P],
    "ayq_sigma_probe": [_P, _I, _I, _P, _P],
    "ayq_postconv": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P, _I, _L, _I,
                     _L, _I, _P],
    "ayq_packed_conv": [_PP, _PI, _I, _PI, _I, _PI, _I, _PI, _I, _PI, _I, _I,
                        _P, _P, _P, _P, _P, _P, _P, _I, _I, _P, _I, _I, _I,
                        _I, _I, _I, _U, _I, _P],
    "ayq_requant_combine": [_I, _PP, _PL, _PI, _I, _I, _I, _I, _P],
    "ayq_dwconv3x3": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P, _I, _I, _I,
                      _I, _I, _P],
    "ayq_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
}

_LIBS: Dict[str, ctypes.CDLL] = {}


def cuda_tool(name: str = "nvcc") -> str:
    """Path of a CUDA toolkit program (nvcc, cuobjdump)."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = shutil.which(name) or os.path.join(home, "bin", name)
    if not os.path.exists(cand):
        raise RuntimeError(f"{name} not found: the Hopper kernels need the "
                           "CUDA toolkit (set CUDA_HOME)")
    return cand


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def targets() -> Dict[str, Path]:
    """Per source, the path of its library; its nvcc and ptxas report is
    the same path with the suffix ``.log``."""
    tag = _digest()
    return {name: BUILD_DIR / f"libayq_{name}_{tag}.so" for name in SOURCES}


def build() -> Dict[str, ctypes.CDLL]:
    """Compile every missing library in parallel and load all of them."""
    if _LIBS:
        return _LIBS
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    libs = targets()
    procs: List = []
    for name, so in libs.items():
        if so.exists():
            continue
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [cuda_tool("nvcc"), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, so, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    # wait for every nvcc before acting on any failure, so none outlives us
    logs = {name: proc.communicate()[0] for name, _, _, proc in procs}
    for name, so, tmp, proc in procs:
        so.with_suffix(".log").write_text(logs[name])
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{logs[name]}")
        # atomic: a concurrent builder never loads half a file
        os.replace(tmp, so)
    for name, so in libs.items():
        lib = ctypes.CDLL(str(so))
        for fn, argtypes in ARGTYPES.items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
        _LIBS[name] = lib
    return _LIBS


def kernel(source: str, fn: str):
    """The C entry point ``fn`` of ``csrc/<source>.cu``, built on first use."""
    return getattr(build()[source], fn)

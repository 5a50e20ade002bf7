"""Build a CUDA source of this package into a shared library at first use.

Each kernel source exposes a plain C interface and is compiled by ``nvcc``
into its own ``.so``, loaded with :mod:`ctypes` (no PyTorch headers, so a
build takes seconds).  Libraries land in ``build/repro_torch_kernels/`` at
the repository root, named by a hash of the source and the flags, so an
edited source is rebuilt and an unchanged one is reused.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Tuple

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"

# Hopper only: the `a` target keeps wgmma/setmaxnreg available to later
# kernels.  -fmad=false and the IEEE division/sqrt flags keep the kernels'
# arithmetic identical to the torch ops they are checked against.
NVCC_FLAGS: Tuple[str, ...] = (
    "-gencode=arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-fmad=false", "-prec-div=true", "-prec-sqrt=true", "-ftz=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
BUILD_LOGS: Dict[str, str] = {}      # library name -> nvcc/ptxas output


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME, the PATH, or /usr/local/cuda; raises if none."""
    cands: List[str] = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        cands.append(which)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built from source at first use")


def load_library(name: str, source: Path) -> ctypes.CDLL:
    """Compile `source` with :data:`NVCC_FLAGS` (if its hashed library is
    missing) and load it."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is not None:
            return lib
        src = Path(source).read_bytes()
        flags = "\0".join(NVCC_FLAGS).encode()
        digest = hashlib.sha256(src + flags).hexdigest()
        out = BUILD_DIR / f"{name}-{digest[:16]}.so"
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            BUILD_LOGS[name] = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed building {name}:\n"
                                   f"{' '.join(cmd)}\n{BUILD_LOGS[name]}")
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        _LIBS[name] = lib
        return lib

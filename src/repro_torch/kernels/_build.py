"""Build a CUDA source of this package into a shared library at first use.

Each kernel source exposes a plain C interface and is compiled by ``nvcc``
into its own ``.so``, loaded with :mod:`ctypes` (no PyTorch headers, so a
build takes seconds).  Libraries land in ``build/repro_torch_kernels/`` at
the repository root, named by a hash of the source and the flags, so an
edited source or a change of flags is rebuilt and an unchanged one is
reused.  Each kernel module states its own flags (``ops.FLAGS``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"

# Hopper only: the `a` target keeps wgmma/setmaxnreg available to later
# kernels.  -fmad=false and the IEEE division/sqrt flags keep the kernels'
# arithmetic identical to the torch ops they are checked against.
NVCC_FLAGS: Tuple[str, ...] = (
    "-gencode=arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-fmad=false", "-prec-div=true", "-prec-sqrt=true", "-ftz=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# Kernels held to a tolerance rather than to bit-exact agreement with torch
# ops (flash_attention, rwkv6_scan): the compiler may contract a*b+c into
# FMAs; division, sqrt and denormals stay IEEE, and there is no fast math.
TOLERANCE_FLAGS: Tuple[str, ...] = (
    "-gencode=arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

Spec = Tuple[Path, Sequence[str]]        # (source, nvcc flags)

_LOCK = threading.Lock()
_LIBS: Dict[Path, ctypes.CDLL] = {}       # library path -> loaded library
BUILD_LOGS: Dict[str, str] = {}           # source stem -> nvcc/ptxas output


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


def library_path(source: Path, flags: Sequence[str]) -> Path:
    """Where `source` built with `flags` lives: named by their hash."""
    digest = hashlib.sha256(Path(source).read_bytes()
                            + "\0".join(flags).encode()).hexdigest()
    return BUILD_DIR / f"{Path(source).stem}-{digest[:16]}.so"


def build(specs: Sequence[Spec]) -> None:
    """Compile each ``(source, flags)`` whose library is missing, every
    nvcc started before any is waited on; raises on the first failure."""
    jobs = []
    for source, flags in specs:
        out = library_path(source, flags)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [find_nvcc(), *flags, "-o", str(tmp), str(source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((Path(source).stem, cmd, tmp, out, proc))
    failed = []
    for name, cmd, tmp, out, proc in jobs:
        BUILD_LOGS[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"nvcc failed building {name}:\n{' '.join(cmd)}\n"
                          f"{BUILD_LOGS[name]}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError(failed[0])


def load_library(source: Path, flags: Sequence[str]) -> ctypes.CDLL:
    """`source` built with `flags` (compiled first if missing), loaded."""
    out = library_path(source, flags)
    with _LOCK:
        lib = _LIBS.get(out)
        if lib is None:
            build([(source, flags)])
            lib = _LIBS[out] = ctypes.CDLL(str(out))
        return lib

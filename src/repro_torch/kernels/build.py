"""Build the port's CUDA sources (``repro_torch/csrc/*.cu``) with nvcc.

Each source compiles on its own into a shared library with a plain C
interface, for ``sm_90a`` (Hopper), at first use; the libraries are loaded
with ctypes. Sources that need building are compiled together, one nvcc
process each, all started at once. Outputs go to ``build/kernels/`` at the
repository root (listed in ``.gitignore``), named by a hash of the source
and the flags, so an unchanged source is not rebuilt. Nothing here runs at
import time: the CPU tests import every module and have no nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}
LOGS: dict[str, str] = {}          # nvcc output (ptxas register/smem report)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    found = shutil.which("nvcc")
    if found is None and CUDA_HOME:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        found = str(cand) if cand.exists() else None
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build repro_torch's kernels")
    return found


def _so_path(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> float:
    """Compile every source whose library is missing; returns seconds."""
    t0 = time.perf_counter()
    todo = [(src, _so_path(src)) for src in sorted(CSRC.glob("*.cu"))]
    todo = [(src, so) for src, so in todo if not so.exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for src, so in todo:
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        p = subprocess.Popen([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                             stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
        procs.append((src, so, tmp, p))
    failed = []
    for src, so, tmp, p in procs:
        out, _ = p.communicate()
        LOGS[src.stem] = out
        if p.returncode != 0:
            failed.append(f"nvcc failed for {src.name}:\n{out}")
        else:
            os.replace(tmp, so)   # atomic: concurrent builds agree
    if failed:
        raise RuntimeError("\n".join(failed))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` (built if needed)."""
    lib = _LIBS.get(name)
    if lib is None:
        so = _so_path(CSRC / f"{name}.cu")
        if not so.exists():
            build_all()
        lib = ctypes.CDLL(str(so))
        _LIBS[name] = lib
    return lib

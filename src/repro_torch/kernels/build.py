"""Build the CUDA sources under ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/*.cu`` becomes a shared library with a plain C interface in
``build/`` next to this file, named by a hash of its source and the flags,
so a changed source rebuilds and an unchanged one is reused. The build runs
at first use (never at import), one nvcc per source, all started together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

__all__ = ["CSRC_DIR", "BUILD_DIR", "NVCC_FLAGS", "build_all", "load"]

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"

# -fmad=false: no multiply-add contraction (the decision layer is compared
# bit for bit); nvcc's default IEEE division and square root stay on.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch are "
                       "built on the machine with the card")


def _target(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, dict]:
    """Compile every source whose library is missing, in parallel.

    Returns ``{stem: {"path", "seconds", "log"}}`` (``seconds`` is 0.0 and
    ``log`` empty for a library that was already built). Raises
    ``RuntimeError`` with nvcc's output if a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out, running = {}, []
    for src in sorted(CSRC_DIR.glob("*.cu")):
        dst = _target(src)
        out[src.stem] = {"path": str(dst), "seconds": 0.0, "log": ""}
        if dst.exists():
            continue
        tmp = dst.with_name(f"{dst.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running.append((src.stem, proc, tmp, dst, time.perf_counter()))
    for stem, proc, tmp, dst, t0 in running:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {stem}.cu:\n{log}")
        os.replace(tmp, dst)
        out[stem].update(seconds=time.perf_counter() - t0, log=log)
    return out


def load(stem: str) -> ctypes.CDLL:
    """The built library of ``csrc/<stem>.cu`` (built on first use)."""
    lib = _LIBS.get(stem)
    if lib is None:
        path = build_all()[stem]["path"]
        lib = _LIBS[stem] = ctypes.CDLL(path)
    return lib

"""Build the CUDA sources under ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/*.cu`` becomes a shared library with a plain C interface in
``build/`` next to this file, named by a hash of its source, of every
``csrc`` header it includes (``#include "name.cuh"``, followed through the
headers' own includes) and of its flags, so a changed source or header
rebuilds and an unchanged one is reused. The build runs
at first use (never at import), one nvcc per source, all started together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

__all__ = ["CSRC_DIR", "BUILD_DIR", "NVCC_FLAGS", "SOURCE_FLAGS", "flags",
           "build_all", "load", "ptxas_summary"]

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"

# nvcc's default IEEE division and square root stay on for every source.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# Flags of one source only. -fmad=false: no multiply-add contraction in the
# sweep step and the policy-update tick, whose decision layers are compared
# bit for bit; the attention and scan kernels keep contraction (they are
# held to a tolerance).
SOURCE_FLAGS = {"hybrid_sweep_step": ("-fmad=false",),
                "policy_update": ("-fmad=false",)}

_LIBS: Dict[str, ctypes.CDLL] = {}


def flags(stem: str) -> tuple:
    """nvcc's flags for ``csrc/<stem>.cu``."""
    return NVCC_FLAGS + SOURCE_FLAGS.get(stem, ())


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch are "
                       "built on the machine with the card")


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)


def _headers(src: Path) -> list:
    """The headers beside ``src`` that it includes, directly or through
    another such header, in the order first met."""
    seen, todo = [], [src]
    while todo:
        for name in _LOCAL_INCLUDE.findall(todo.pop(0).read_bytes()):
            path = src.parent / name.decode()
            if path.is_file() and path not in seen:
                seen.append(path)
                todo.append(path)
    return seen


def _target(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes())
    for header in _headers(src):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(flags(src.stem)).encode())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def _kernel_name(mangled: str) -> str:
    """``name<args>`` of a mangled kernel: the identifier that ends in
    ``_kernel`` and its integer template arguments, with f32 or bf16 where
    a type argument is float or __nv_bfloat16."""
    pos = 0
    while True:
        m = re.compile(r"(\d+)[A-Za-z_]").search(mangled, pos)
        if m is None:
            return mangled
        start = m.start() + len(m.group(1))
        ident = mangled[start:start + int(m.group(1))]
        pos = start + len(ident)
        if ident.endswith("_kernel"):
            break
    targs = mangled[pos:].split("Ev")[0] if mangled[pos:pos + 1] == "I" \
        else ""
    args = (["f32"] if targs.startswith("If") else []) + \
        (["bf16"] if "nv_bfloat16" in targs else []) + \
        re.findall(r"Li(\d+)E", targs)
    return ident + (f"<{','.join(args)}>" if args else "")


def ptxas_summary(log: str) -> Dict[str, dict]:
    """Registers and spill bytes of each kernel in an nvcc ``-Xptxas -v``
    log, keyed by the kernel's name and template arguments (e.g.
    ``flash_attention_hopper_kernel<128>``, ``..._kernel<bf16,64>``)."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = _kernel_name(m.group(1))
            out[name] = {"registers": None, "spill_bytes": 0}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            out[name]["spill_bytes"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
            name = None
    return out


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
        cmd = [_nvcc(), *flags(src.stem), "-o", str(tmp), str(src)]
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

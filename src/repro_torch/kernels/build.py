"""Build the CUDA sources under ``csrc/`` with nvcc, load them with ctypes
and run their entry points.

Each ``csrc/*.cu`` becomes a shared library with a plain C interface in
``build/`` next to this file, named by a hash of its source, of every
``csrc`` header it includes (``#include "name.cuh"``, followed through the
headers' own includes) and of its flags, so a changed source or header
rebuilds and an unchanged one is reused. The build runs
at first use (never at import), one nvcc per source, all started together.

Every C entry point is typed from one table, :data:`SIGNATURES`, when its
library is loaded, and run through :func:`launch`.
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
from typing import Dict, Optional

import torch

__all__ = ["CSRC_DIR", "BUILD_DIR", "NVCC_FLAGS", "SOURCE_FLAGS",
           "SIGNATURES", "CTYPES", "flags", "build_all", "entry_points",
           "load", "launch", "ptxas_summary"]

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

#: The C interface of each library: stem -> (its error-string function,
#: {entry point: (return type, argument types)}), a letter a C type (see
#: :data:`CTYPES`; spaces only group the letters for the reader). An error-
#: string function takes an entry point's nonzero return code and gives
#: the library's message for it (``int`` -> ``const char*``).
SIGNATURES = {
    "decode_attention": ("decode_attention_error_string", {
        "decode_attention_fwd":
            ("i", "pppp pppp iiiiiiii p ii LLLLLLLL ff p")}),
    "expert_gather": ("expert_gather_error_string", {
        "expert_gather_fwd": ("i", "ppppppppp iiiiiiiii p")}),
    "flash_attention": ("flash_attention_error_string", {
        "flash_attention_fwd": ("i", "pppp iiiiiii LLLLLLLLL f p"),
        "flash_attention_hopper_fwd": ("i", "pppp iiiiii LLLLLLLLL f p")}),
    "hybrid_sweep_step": ("hybrid_error_string", {
        "hybrid_sweep_step": ("i", "ppppppppppppp pppppppp iii p"),
        "hybrid_sweep_scan":
            ("i", "pi pppppppppppp pppppppp p iiii p"),
        "hybrid_sweep_scan_factored":
            ("i", "pi ppppppppp ppppp ppppppppp iiiii p")}),
    "policy_update": ("policy_update_error_string", {
        "policy_update": ("i", "ppppppp ppppppp iiiii ffffff i p")}),
    "rglru_scan": ("rglru_scan_error_string", {
        "rglru_scan_fwd": ("i", "pppp iiii p")}),
    "rope_append": ("rope_append_error_string", {
        "rope_append_fwd": ("i", "ppppppp L iiiii LLL f iiii p")}),
    "ssd_scan": ("ssd_scan_error_string", {
        "ssd_scan_scratch_bytes": ("L", "iiiiiiii"),
        "ssd_scan_bf16_max_state": ("i", ""),
        "ssd_scan_fwd": ("i", "ppppppppp iiiiiiii LLLLLLLLLLL p")}),
}

#: The ctypes type of each letter of :data:`SIGNATURES`: ``p`` any pointer
#: (device memory, or the ``cudaStream_t`` passed as ``void*``), ``i``
#: ``int``, ``L`` ``int64_t``, ``f`` ``float``, ``s`` ``const char*``.
CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "L": ctypes.c_int64,
          "f": ctypes.c_float, "s": ctypes.c_char_p}

_LIBS: Dict[str, ctypes.CDLL] = {}


def entry_points():
    """``(stem, name, return letter, argument letters)`` of every C entry
    point of :data:`SIGNATURES`, the error-string functions included."""
    for stem, (err, fns) in SIGNATURES.items():
        for name, (ret, args) in fns.items():
            yield stem, name, ret, args.replace(" ", "")
        yield stem, err, "s", "i"


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
        # repro-lint: ignore[nondeterminism] -- nvcc's wall seconds a
        # source, reported beside the build; the library does not depend
        # on them
        running.append((src.stem, proc, tmp, dst, time.perf_counter()))
    for stem, proc, tmp, dst, t0 in running:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {stem}.cu:\n{log}")
        os.replace(tmp, dst)
        # repro-lint: ignore[nondeterminism] -- end of the build's measurement
        out[stem].update(seconds=time.perf_counter() - t0, log=log)
    return out


def _bind(lib, stem: str):
    """Type every entry point of ``lib``, the library of ``csrc/<stem>.cu``,
    from :data:`SIGNATURES`."""
    for s, name, ret, args in entry_points():
        if s == stem:
            fn = getattr(lib, name)
            fn.argtypes = [CTYPES[c] for c in args]
            fn.restype = CTYPES[ret]
    return lib


def load(stem: str) -> ctypes.CDLL:
    """The built library of ``csrc/<stem>.cu`` (built on first use), its
    entry points typed from :data:`SIGNATURES`."""
    lib = _LIBS.get(stem)
    if lib is None:
        path = build_all()[stem]["path"]
        lib = _LIBS[stem] = _bind(ctypes.CDLL(path), stem)
    return lib


def launch(stem: str, entry: str, device, *args, what: Optional[str] = None,
           form: Optional[str] = None) -> None:
    """Call entry point ``entry`` of ``csrc/<stem>.cu`` with ``args`` and,
    last, ``device``'s current CUDA stream. A nonzero return raises
    ``RuntimeError("<what> launch failed (<form> form): <message>")`` (the
    form's part only with ``form``; ``what`` defaults to ``stem``), the
    message the library's own error string for the code."""
    lib = load(stem)
    with torch.cuda.device(device):
        rc = getattr(lib, entry)(*args,
                                 torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        message = getattr(lib, SIGNATURES[stem][0])(rc).decode()
        how = f" ({form} form)" if form else ""
        raise RuntimeError(f"{what or stem} launch failed{how}: {message}")

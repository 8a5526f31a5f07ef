"""``repro_torch.kernels.build`` without nvcc: a library's name follows its
source, the ``csrc`` headers the source includes (directly or through
another header) and its flags, so a changed header cannot reuse a stale
library; the ptxas log parser that ``chip_smoke.py`` prints registers
and spills with; and the signature table that types every C entry point,
held to the ``extern "C"`` prototypes of ``csrc/*.cu`` (ctypes passes
whatever it is told, so a miscounted or mistyped argument would reach the
kernel with no error), and applied to a library as it is loaded."""
import ctypes
import re
from types import SimpleNamespace

import pytest

from repro_torch.kernels import build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    (tmp_path / "util.cuh").write_text("// util v1\n")
    (tmp_path / "shared.cuh").write_text('#include "util.cuh"\n// shared\n')
    src = tmp_path / "kern.cu"
    src.write_text('#include <cuda_runtime.h>\n#include "shared.cuh"\n'
                   "// kernel\n")
    return tmp_path, src


def test_headers_are_followed_through_includes(csrc):
    root, src = csrc
    assert [p.name for p in build._headers(src)] == ["shared.cuh", "util.cuh"]


@pytest.mark.parametrize("changed", ["kern.cu", "shared.cuh", "util.cuh"])
def test_target_changes_when_the_source_or_a_header_changes(csrc, changed):
    root, src = csrc
    before = build._target(src)
    assert before == build._target(src)                   # deterministic
    assert before.parent == root / "build"
    path = root / changed
    path.write_text(path.read_text() + "// edited\n")
    assert build._target(src) != before


def test_target_ignores_headers_it_does_not_include(csrc):
    root, src = csrc
    before = build._target(src)
    (root / "other.cuh").write_text("// not included\n")
    assert build._target(src) == before


def test_target_changes_with_the_flags(csrc, monkeypatch):
    root, src = csrc
    before = build._target(src)
    monkeypatch.setitem(build.SOURCE_FLAGS, "kern", ("-fmad=false",))
    assert build._target(src) != before


def test_ptxas_summary_names_each_kernel():
    log = "\n".join([
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_11h29flash_attention_hopper_kernelILi128EEEv14"
        "CUtensorMap_stS2_S2_P13__nv_bfloat16iiiif' for 'sm_90a'",
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_11h29flash"
        "_attention_hopper_kernelILi128EEEv14CUtensorMap_stS2_S2_P13__nv_"
        "bfloat16iiiif",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 168 registers, used 1 barriers",
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_128decode_"
        "attention_core_kernelIfLi64EEEvPKT_S3_S3_PS1_",
        "    8 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads",
        "ptxas info    : Used 96 registers, used 1 barriers",
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_128decode_"
        "attention_core_kernelI13__nv_bfloat16Li256EEEvPKT_",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 70 registers, used 1 barriers",
    ])
    assert build.ptxas_summary(log) == {
        "flash_attention_hopper_kernel<128>": {"registers": 168,
                                               "spill_bytes": 0},
        "decode_attention_core_kernel<f32,64>": {"registers": 96,
                                                 "spill_bytes": 8},
        "decode_attention_core_kernel<bf16,256>": {"registers": 70,
                                                   "spill_bytes": 0},
    }


# -- the signature table ---------------------------------------------------

_PROTOTYPE = re.compile(r"^([A-Za-z_][\w \t*]*?[ \t*])([A-Za-z_]\w*)\s*"
                        r"\(([^)]*)\)\s*\{", re.M)


def _letter(ctype: str) -> str:
    """The table's letter of a C type (no parameter name)."""
    t = " ".join(ctype.replace("*", " * ").split())
    if t == "const char *":
        return "s"
    if t.endswith("*"):
        return "p"
    return {"int": "i", "int64_t": "L", "float": "f"}[t.replace("const ", "")]


def _exported(stem: str) -> dict:
    """``{name: (return letter, argument letters)}`` of every function
    defined at the top of the ``extern "C"`` blocks of ``csrc/<stem>.cu``."""
    text = (build.CSRC_DIR / f"{stem}.cu").read_text()
    text = re.sub(r"/\*.*?\*/", "", re.sub(r"//[^\n]*", "", text), flags=re.S)
    out = {}
    for m in re.finditer(r'extern\s+"C"\s*\{', text):
        i, depth = m.end(), 1
        while depth:
            depth += {"{": 1, "}": -1}.get(text[i], 0)
            i += 1
        block = text[m.end():i - 1]
        for f in _PROTOTYPE.finditer(block):
            if block[:f.start()].count("{") != block[:f.start()].count("}"):
                continue                          # inside a function body
            ret, name, params = f.groups()
            params = [p.strip() for p in params.split(",")]
            types = [p if p.endswith("*") else re.sub(r"\s*\w+$", "", p)
                     for p in params if p not in ("", "void")]
            assert name not in out, f"{stem}.cu exports {name} twice"
            out[name] = (_letter(ret), "".join(_letter(t) for t in types))
    return out


@pytest.mark.parametrize("stem,name,ret,args",
                         list(build.entry_points()),
                         ids=[f"{stem}.{name}" for stem, name, *_ in
                              build.entry_points()])
def test_signature_matches_the_c_prototype(stem, name, ret, args):
    exported = _exported(stem)
    assert name in exported, f"csrc/{stem}.cu exports no {name}"
    want_ret, want_args = exported[name]
    assert len(args) == len(want_args), (name, args, want_args)
    assert [build.CTYPES[c] for c in args] == \
        [build.CTYPES[c] for c in want_args], (name, args, want_args)
    assert build.CTYPES[ret] is build.CTYPES[want_ret], (name, ret)


def test_every_exported_function_is_in_the_table_once():
    table = [(stem, name) for stem, name, *_ in build.entry_points()]
    assert len(table) == len(set(table))
    assert {stem for stem, _ in table} == \
        {p.stem for p in build.CSRC_DIR.glob("*.cu")}
    exported = [(p.stem, name) for p in build.CSRC_DIR.glob("*.cu")
                for name in _exported(p.stem)]
    assert sorted(exported) == sorted(table)


def test_bind_types_a_library_from_the_table():
    fns = {name: SimpleNamespace(argtypes=None, restype=None)
           for stem, name, *_ in build.entry_points() if stem == "ssd_scan"}
    build._bind(SimpleNamespace(**fns), "ssd_scan")
    assert fns["ssd_scan_scratch_bytes"].argtypes == [ctypes.c_int] * 8
    assert fns["ssd_scan_scratch_bytes"].restype is ctypes.c_int64
    assert fns["ssd_scan_bf16_max_state"].argtypes == []
    assert fns["ssd_scan_error_string"].restype is ctypes.c_char_p
    fwd = fns["ssd_scan_fwd"].argtypes
    assert fwd == [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + \
        [ctypes.c_int64] * 11 + [ctypes.c_void_p]

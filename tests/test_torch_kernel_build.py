"""``repro_torch.kernels.build`` without nvcc: a library's name follows its
source, the ``csrc`` headers the source includes (directly or through
another header) and its flags, so a changed header cannot reuse a stale
library; and the ptxas log parser that ``chip_smoke.py`` prints registers
and spills with."""
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

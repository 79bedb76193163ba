"""``native.py``'s library names: a hash of the source and of every local
header it includes (``#include "..."``, followed recursively), so that an
edited header rebuilds each library that includes it, as
``csrc/int8_hopper.cuh`` does ``csrc/int8_gemm.cu``'s and
``csrc/int8_conv3x3.cu``'s. No compiler runs here."""

from ball_action_spotting_torch import native
from ball_action_spotting_torch.ops._cuda import CudaKernel
from ball_action_spotting_torch.ops.int8_conv import CONV3X3_KERNEL, GEMM_KERNEL, KERNEL


def test_source_files_follow_local_includes(tmp_path):
    (tmp_path / "a.cu").write_text('#include <cuda.h>\n#include "h.cuh"\nint a;\n')
    (tmp_path / "h.cuh").write_text('#pragma once\n  #  include "g.cuh"\n#include "g.cuh"\n')
    (tmp_path / "g.cuh").write_text("int g;\n")
    assert native.source_files(tmp_path / "a.cu") == [
        tmp_path / "a.cu", tmp_path / "h.cuh", tmp_path / "g.cuh"]


def test_an_edited_header_renames_the_library(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "CSRC_DIR", tmp_path)
    (tmp_path / "k.cu").write_text('#include "h.cuh"\nint k;\n')
    (tmp_path / "h.cuh").write_text("int h;\n")
    kernel = CudaKernel("k", "k_forward", [])
    before = kernel.library
    assert before.name.startswith("libk-") and before.parent == native.BUILD_DIR
    (tmp_path / "h.cuh").write_text("int h2;\n")
    assert kernel.library != before
    (tmp_path / "h.cuh").write_text("int h;\n")
    assert kernel.library == before


def test_both_hopper_int8_sources_include_the_shared_header():
    header = native.CSRC_DIR / "int8_hopper.cuh"
    for kernel in (GEMM_KERNEL, CONV3X3_KERNEL):
        assert header in native.source_files(kernel.source)
    assert native.source_files(KERNEL.source) == [KERNEL.source]

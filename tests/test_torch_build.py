"""The port's kernel build (repro_torch.kernels.build) on the CPU: the library
name's digest covers a source, every csrc header it includes (directly or
through another header) and the flags, so an edit to a shared header
rebuilds every kernel that includes it.  Nothing here compiles: the digest is
computed from the files alone."""
import pytest

pytest.importorskip("torch")

from repro_torch.kernels import build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "CSRC", tmp_path)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    (tmp_path / "shared.cuh").write_text('#pragma once\n#include "inner.cuh"\n')
    (tmp_path / "inner.cuh").write_text("constexpr int kInner = 1;\n")
    (tmp_path / "other.cuh").write_text("constexpr int kOther = 1;\n")
    (tmp_path / "a.cu").write_text('#include <cuda_runtime.h>\n#include "shared.cuh"\n')
    (tmp_path / "b.cu").write_text('  #  include "shared.cuh"\nint b;\n')
    (tmp_path / "c.cu").write_text("int c;\n")
    return tmp_path


def test_sources_follow_quoted_includes_transitively(csrc):
    assert [p.name for p in build._sources("a")] == ["a.cu", "shared.cuh", "inner.cuh"]
    assert [p.name for p in build._sources("b")] == ["b.cu", "shared.cuh", "inner.cuh"]
    assert [p.name for p in build._sources("c")] == ["c.cu"]


@pytest.mark.parametrize("header", ["shared.cuh", "inner.cuh"])
def test_editing_a_header_changes_the_digest_of_every_includer(csrc, header):
    before = {n: build._lib_path(n) for n in "abc"}
    (csrc / header).write_text((csrc / header).read_text() + "// edit\n")
    after = {n: build._lib_path(n) for n in "abc"}
    assert after["a"] != before["a"] and after["b"] != before["b"]
    assert after["c"] == before["c"]


def test_an_unincluded_header_and_the_build_dir_do_not_move_the_digest(csrc):
    before = build._lib_path("a")
    (csrc / "other.cuh").write_text("constexpr int kOther = 2;\n")
    assert build._lib_path("a") == before
    assert before.parent == csrc / "_build" and before.name.startswith("liba-")


def test_the_port_kernels_that_share_fast_div_hash_it():
    names = {n: [p.name for p in build._sources(n)] for n in ("fail_prob", "rc_transient")}
    assert all("fast_div.cuh" in files for files in names.values())
    assert [p.name for p in build._sources("bank_sched")] == ["bank_sched.cu"]


def test_chip_smoke_reads_registers_and_spills_from_the_report():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_for_test", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    log = "\n".join([
        "ptxas info    : Compiling entry function '_ZN1a15wkv6_bwd_kernelILi64EEEvPKv' for 'sm_90a'",
        "ptxas info    : Function properties for _ZN1a15wkv6_bwd_kernelILi64EEEvPKv",
        "    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads",
        "ptxas info    : Used 128 registers, used 1 barriers",
        "ptxas info    : Compiling entry function '_ZN1a14wkv6_du_kernelEPKf' for 'sm_90a'",
        "ptxas info    : Function properties for _ZN1a14wkv6_du_kernelEPKf",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 32 registers, used 0 barriers"])
    assert smoke.ptxas_report(log, "wkv6_bwd_kernel") == {
        "_ZN1a15wkv6_bwd_kernelILi64EEEvPKv": {"spill_stores": 8, "spill_loads": 4,
                                              "registers": 128}}
    assert smoke.ptxas_report("", "wkv6_bwd_kernel") == {}

"""Port parity of the reliability codec: repro_torch.memsys.codec against
repro.memsys.codec on the CPU — identical stored lanes, recovered bytes and
statistics, for the reference's own codec cases.  Tier: exact."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from hypothesis import given, settings, strategies as st

from repro.memsys import codec as rcodec
from repro_torch.kernels import ops
from repro_torch.memsys import codec as tcodec

CPU = dict(device="cpu")


def _protect_both(data, shuffle=True):
    got = tcodec.protect_blob(data, shuffle=shuffle, **CPU)
    want = rcodec.protect_blob(data, shuffle=shuffle)
    assert got.dtype == want.dtype == np.int8
    np.testing.assert_array_equal(got, want)
    return got


def _fields(stats):
    return stats.codewords, stats.corrected, stats.uncorrectable


def _recover_both(lanes, n_bytes, shuffle=True):
    out, stats = tcodec.recover_blob(lanes, n_bytes, shuffle=shuffle, **CPU)
    rout, rstats = rcodec.recover_blob(lanes, n_bytes, shuffle=shuffle)
    assert out == rout
    assert _fields(stats) == _fields(rstats)
    return out, stats


def test_interleave_roundtrip_and_runs_as_in_reference():
    data = bytes(range(200)) * 2
    lanes = _protect_both(data)
    out, stats = _recover_both(lanes, len(data))
    assert out == data and stats.ok and stats.corrected == 0
    # a contiguous 7-bit run spreads over 7 distinct codewords -> corrected
    bad = tcodec.corrupt_run(lanes, burst=0, start_lane=101, n_bits=7)
    np.testing.assert_array_equal(
        bad, rcodec.corrupt_run(lanes, burst=0, start_lane=101, n_bits=7))
    out, stats = _recover_both(bad, len(data))
    assert out == data and stats.ok and stats.corrected == 7
    # codeword-major layout eats the same run in one word -> uncorrectable
    nl = _protect_both(data, shuffle=False)
    bad = tcodec.corrupt_run(nl, burst=0, start_lane=4, n_bits=6)
    _, stats = _recover_both(bad, len(data), shuffle=False)
    assert not stats.ok


@given(st.binary(min_size=1, max_size=600), st.integers(0, 560),
       st.integers(1, 8))
@settings(max_examples=25, deadline=None)
def test_codec_corrects_contiguous_runs(data, start, nbits):
    lanes = _protect_both(data)
    bad = tcodec.corrupt_run(lanes, burst=0, start_lane=start, n_bits=nbits)
    out, stats = _recover_both(bad, len(data))
    assert stats.ok and stats.corrected == min(nbits, 576 - start)
    assert out == data


def test_codec_without_shuffle_fails_on_runs():
    data = b"x" * 512
    lanes = _protect_both(data, shuffle=False)
    bad = tcodec.corrupt_run(lanes, burst=0, start_lane=4, n_bits=6)
    _, stats = _recover_both(bad, len(data), shuffle=False)
    assert not stats.ok


def test_scrub_repairs_in_place_as_in_reference():
    data = b"hello world" * 40
    lanes = _protect_both(data)
    bad = tcodec.corrupt_run(lanes, burst=1, start_lane=33, n_bits=5)
    fixed, stats = tcodec.scrub(bad, len(data), **CPU)
    rfixed, rstats = rcodec.scrub(bad, len(data))
    np.testing.assert_array_equal(fixed, rfixed)
    assert _fields(stats) == _fields(rstats)
    assert stats.ok and stats.corrected > 0
    out, stats2 = _recover_both(fixed, len(data))
    assert out == data and stats2.corrected == 0
    # an uncorrectable blob comes back as it was
    worse = tcodec.corrupt_run(_protect_both(data, shuffle=False), burst=0,
                               start_lane=0, n_bits=2)
    same, stats3 = tcodec.scrub(worse, len(data), shuffle=False, **CPU)
    assert same is worse and not stats3.ok


def test_recover_takes_a_tensor_and_empty_blobs():
    data = bytes(range(64))
    lanes = _protect_both(data)
    out, stats = tcodec.recover_blob(torch.as_tensor(lanes), len(data), **CPU)
    assert out == data and stats.codewords == 8
    empty = _protect_both(b"")
    assert empty.shape == (0, 576)
    assert _recover_both(empty, 0)[0] == b""


def test_cpu_codec_launches_no_kernel():
    ops.reset_launches()
    lanes = tcodec.protect_blob(b"abc" * 100, **CPU)
    tcodec.recover_blob(lanes, 300, **CPU)
    assert set(ops.launch_counts().values()) == {0}

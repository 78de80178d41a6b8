"""Port parity of the SECDED(72,64) code: repro_torch.core.ecc against
repro.core.ecc on the CPU, on seeded random words and on every single- and
double-bit error pattern of a few words.  Tier: exact (integer bits)."""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from hypothesis import given, settings, strategies as st

from repro.core import ecc as recc
from repro_torch.core import ecc as tecc


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _words(n, seed=0):
    return np.random.default_rng(seed).integers(0, 2, (n, 64)).astype(np.int32)


def test_constants_match_reference():
    np.testing.assert_array_equal(tecc.H_DATA, recc.H_DATA)
    np.testing.assert_array_equal(tecc.H_FULL, recc.H_FULL)
    np.testing.assert_array_equal(tecc._POW2, recc._POW2)
    np.testing.assert_array_equal(tecc._SYN_TO_POS, recc._SYN_TO_POS)
    assert (tecc.DATA_BITS, tecc.CHECK_BITS, tecc.CODE_BITS) == (64, 8, 72)


@pytest.mark.parametrize("n", [1, 17, 300])
def test_encode_and_syndrome_match_reference(n):
    data = _words(n, seed=n)
    code = tecc.encode(torch.as_tensor(data))
    assert code.dtype == torch.int32 and code.shape == (n, 72)
    np.testing.assert_array_equal(_np(code), _np(recc.encode(data)))
    noisy = np.random.default_rng(n + 1).integers(0, 2, (n, 72)).astype(np.int32)
    np.testing.assert_array_equal(_np(tecc.syndrome(torch.as_tensor(noisy))),
                                  _np(recc.syndrome(noisy)))
    # a clean codeword has a zero syndrome
    assert not tecc.syndrome(code).any()


def _decode_both(code):
    got_data, got_status = tecc.decode(torch.as_tensor(code))
    want_data, want_status = recc.decode(code)
    np.testing.assert_array_equal(_np(got_data), _np(want_data))
    np.testing.assert_array_equal(_np(got_status), _np(want_status))
    fixed, status = tecc.correct_codewords(torch.as_tensor(code),
                                           tecc.syndrome(torch.as_tensor(code)))
    rfixed, rstatus = recc.correct_codewords(code, recc.syndrome(code))
    np.testing.assert_array_equal(_np(fixed), _np(rfixed))
    np.testing.assert_array_equal(_np(status), _np(rstatus))
    return _np(got_data), _np(got_status)


def test_every_single_bit_error_is_corrected_as_in_reference():
    data = _words(3, seed=5)
    clean = _np(recc.encode(data))
    code = np.repeat(clean, 72, axis=0)                  # (3*72, 72)
    pos = np.tile(np.arange(72), 3)
    code[np.arange(len(code)), pos] ^= 1
    got, status = _decode_both(code)
    assert (status == 1).all()
    np.testing.assert_array_equal(got, np.repeat(data, 72, axis=0))


def test_every_double_bit_error_is_detected_as_in_reference():
    data = _words(1, seed=6)
    clean = _np(recc.encode(data))
    pairs = np.array(list(itertools.combinations(range(72), 2)))
    code = np.repeat(clean, len(pairs), axis=0)
    rows = np.arange(len(code))
    code[rows, pairs[:, 0]] ^= 1
    code[rows, pairs[:, 1]] ^= 1
    _, status = _decode_both(code)
    assert (status == 2).all()


def test_clean_and_random_words_decode_as_in_reference():
    code = np.concatenate([
        _np(recc.encode(_words(40, seed=7))),
        np.random.default_rng(8).integers(0, 2, (200, 72)).astype(np.int32)])
    _, status = _decode_both(code)
    assert set(np.unique(status)) == {0, 1, 2}


@given(st.binary(min_size=0, max_size=200), st.integers(0, 10 ** 6))
@settings(max_examples=25, deadline=None)
def test_protect_and_recover_bytes_match_reference(data, flip):
    got = tecc.protect_bytes(data, device="cpu")
    want = recc.protect_bytes(data)
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    if got.size:
        row, bit = divmod(flip % (got.shape[0] * 72), 72)
        got[row, bit // 8] ^= np.uint8(1 << (bit % 8))   # one bit per word
        want[row, bit // 8] ^= np.uint8(1 << (bit % 8))
    out, status = tecc.recover_bytes(got, len(data), device="cpu")
    rout, rstatus = recc.recover_bytes(want, len(data))
    assert out == rout == data
    np.testing.assert_array_equal(status, np.asarray(rstatus))


def test_byte_helpers_match_reference():
    b = np.random.default_rng(9).integers(0, 256, (5, 8)).astype(np.uint8)
    np.testing.assert_array_equal(tecc.bytes_to_bits(b), recc.bytes_to_bits(b))
    bits = recc.bytes_to_bits(b)
    np.testing.assert_array_equal(tecc.bits_to_bytes(bits),
                                  recc.bits_to_bytes(bits))

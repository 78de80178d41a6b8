"""Port parity: the counter hash of repro_torch.core.hashing gives the bits of
repro.core.substrate.query_uniform, in numpy and in torch (int64 masked to
32 bits), over hypothesis-drawn keys.  Tier: exact."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from hypothesis import given, settings, strategies as st

from repro.core.substrate import _mix32 as ref_mix32
from repro.core.substrate import query_uniform as ref_query_uniform
from repro_torch.core import hashing

u32s = st.integers(0, 2**32 - 1)


@settings(max_examples=60, deadline=None)
@given(st.lists(u32s, min_size=1, max_size=64))
def test_mix32_numpy_and_torch_match_reference(keys):
    h = np.asarray(keys, np.uint32)
    want = ref_mix32(h, np)
    np.testing.assert_array_equal(hashing._mix32(h), want)
    got_t = hashing._mix32_t(torch.as_tensor(np.asarray(keys, np.int64)))
    np.testing.assert_array_equal(got_t.numpy(), want.astype(np.int64))


@settings(max_examples=60, deadline=None)
@given(serials=st.lists(u32s, min_size=1, max_size=16),
       param_idx=st.integers(0, 3), t_q=st.integers(0, 200),
       multibit=st.integers(0, 1), n_sub=st.integers(1, 8),
       n_pat=st.integers(1, 4))
def test_query_uniform_matches_reference(serials, param_idx, t_q, multibit,
                                         n_sub, n_pat):
    """Serials span the whole uint32 range, so keys >= 2**31 (negative as
    int32) are covered."""
    serial = np.asarray(serials, np.uint32)[:, None, None]
    sub = np.arange(n_sub)[None, :, None]
    pat = np.arange(n_pat)[None, None, :]
    want = ref_query_uniform(serial, param_idx, t_q, multibit, sub, pat)
    got_np = hashing.query_uniform(serial, param_idx, t_q, multibit, sub, pat)
    np.testing.assert_array_equal(got_np, want)
    got_t = hashing.query_uniform_t(
        torch.as_tensor(serial.astype(np.int64)), param_idx,
        torch.tensor(t_q), multibit, torch.as_tensor(sub),
        torch.as_tensor(pat))
    assert got_t.dtype == torch.float32
    np.testing.assert_array_equal(got_t.numpy(), want)


@pytest.mark.parametrize("t_op", [5.0, 7.5, 13.75, 0.125, 0.375, 22.625])
def test_quantize_t_half_to_even_in_both_frameworks(t_op):
    """The sweep rounds t_op*4 on the device (torch.round, half to even) and
    the walker on the host (Python round): one key either way."""
    from repro.core.substrate import quantize_t as ref_quantize_t
    on_device = int(torch.round(torch.tensor(t_op, dtype=torch.float32) * 4))
    assert hashing.quantize_t(t_op) == ref_quantize_t(t_op) == on_device

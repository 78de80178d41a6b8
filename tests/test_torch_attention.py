"""The port's attention, rotary, MLP and int8 KV-cache helpers against the
reference on the CPU: ``apply_rope``, ``rope_freqs``, ``mlp_apply`` (swiglu,
gelu_glu, gelu), ``full_attention`` (GQA 1, 2 and 4, with and without a
bidirectional prefix, causal and not), ``blockwise_attention`` (key lengths
not a multiple of ``block_kv``, causal and not, with a prefix),
``decode_attention`` at several cache positions, ``attention_block`` on both
of its branches, ``qkv`` with biases and rotary, and ``_q8``/``_dq``.  The
inputs are drawn from a seed with numpy and go through both packages.

Tolerances (float32):
- rotary, MLP and ``qkv``: rtol = atol = 1e-6 (2.4e-7 measured on rotary
  and ``qkv``, 9.5e-7 on MLP outputs of order 10; the reference's
  ``theta ** x``, ``cos``, ``sin`` and products are XLA's);
- attention: rtol = atol = 1e-5 (the products sum in other orders and XLA's
  ``exp`` is its own: up to 4.8e-7 measured, on ``attention_block``);
- ``_q8``/``_dq`` on the same input: identical bits (int8 values, bfloat16
  scales, dequantized bfloat16);
- bfloat16 inputs, where both packages round the same float32 sums:
  identical bits for ``decode_attention`` (float32 weights, one cast at the
  end) and within 1 bfloat16 ulp (rtol 2**-7) for ``full_attention`` (its
  weights are cast to bfloat16 before the second product).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs.registry import get_smoke_config as ref_smoke
from repro.models import attention as ref_attn
from repro.models import cache as ref_cache
from repro.models import layers as ref_layers
from repro_torch.configs.registry import get_smoke_config
from repro_torch.models import attention as attn
from repro_torch.models import cache as port_cache
from repro_torch.models import layers
from repro_torch.models import model

LAYER_TOL = 1e-6
ATTN_TOL = 1e-5
BF16_RTOL = 2.0 ** -7


def _np(t):
    return t.detach().float().numpy()


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), rtol=tol, atol=tol)


def _qkv_arrays(seed, B, Sq, Skv, H, KVH, dh):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (B, Sq, H, dh)).astype(np.float32),
            rng.normal(0, 1, (B, Skv, KVH, dh)).astype(np.float32),
            rng.normal(0, 1, (B, Skv, KVH, dh)).astype(np.float32))


def _both(arrays, dtype=np.float32):
    """(jnp arrays, torch tensors) of the same values in ``dtype``."""
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    return ([jnp.asarray(a).astype(jd) for a in arrays],
            [torch.from_numpy(a).to(td) for a in arrays])


# ------------------------------------------------------------ rotary, MLP

@pytest.mark.parametrize("dh,theta", [(16, 10000.0), (64, 10000.0), (128, 1e6)])
def test_rope_freqs_match_reference(dh, theta):
    got = layers.rope_freqs(dh, theta)
    assert got.dtype == torch.float32 and got.shape == (dh // 2,)
    _close(got, ref_layers.rope_freqs(dh, theta), LAYER_TOL)


@pytest.mark.parametrize("shape,dtype", [((2, 9, 4, 16), "float32"), ((1, 5, 3, 64), "float32"),
                                         ((2, 9, 4, 16), "bfloat16")])
def test_apply_rope_matches_reference(shape, dtype):
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, shape).astype(np.float32)
    pos = (np.arange(shape[1]) * 7 + 3).astype(np.int32)
    (xj,), (xt,) = _both([x], dtype)
    got = layers.apply_rope(xt, torch.from_numpy(pos), 10000.0)
    want = ref_layers.apply_rope(xj, jnp.asarray(pos), 10000.0)
    assert got.dtype == xt.dtype
    if dtype == "float32":
        _close(got, want, LAYER_TOL)
    else:
        np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), rtol=BF16_RTOL,
                                   atol=1e-6)
    # the two halves rotate together: position 0 leaves x as it is
    same = layers.apply_rope(xt, torch.zeros(shape[1], dtype=torch.int32), 10000.0)
    assert torch.equal(same, xt)


@pytest.mark.parametrize("act", ["swiglu", "gelu_glu", "gelu"])
def test_mlp_apply_matches_reference(act):
    """``jax.nn.gelu`` is the tanh approximation by default: an erf gelu
    would sit ~1e-3 away."""
    cfg = get_smoke_config("qwen2-0.5b").replace(act=act)
    ref_p = ref_layers.mlp_params(jax.random.PRNGKey(5), cfg, jnp.float32)
    ref_p = jax.tree.map(lambda a: a + 0.1 if a.ndim == 1 else a, ref_p)  # nonzero biases
    p = model.params_from_numpy(jax.tree.map(np.asarray, ref_p), "cpu")
    port_p = layers.mlp_params(torch.Generator().manual_seed(0), cfg, torch.float32)
    assert {k: tuple(v.shape) for k, v in port_p.items() if k != "ln"} == \
        {k: np.shape(v) for k, v in ref_p.items() if k != "ln"}
    x = np.random.default_rng(2).normal(0, 1.5, (2, 7, cfg.d_model)).astype(np.float32)
    _close(layers.mlp_apply(cfg, p, torch.from_numpy(x)),
           ref_layers.mlp_apply(cfg, ref_p, jnp.asarray(x)), LAYER_TOL)


def test_qkv_with_bias_and_rope_matches_reference():
    cfg = get_smoke_config("qwen2-0.5b")
    ref_p = ref_attn.attn_params(jax.random.PRNGKey(7), cfg, jnp.float32)
    ref_p = {k: (v + 0.05 if k in ("bq", "bk", "bv") else v) for k, v in ref_p.items()}
    p = model.params_from_numpy(jax.tree.map(np.asarray, ref_p), "cpu")
    x = np.random.default_rng(3).normal(0, 1, (2, 6, cfg.d_model)).astype(np.float32)
    pos = np.arange(6, dtype=np.int32)
    for got, want in zip(attn.qkv(cfg, p, torch.from_numpy(x), torch.from_numpy(pos)),
                         ref_attn.qkv(cfg, ref_p, jnp.asarray(x), jnp.asarray(pos))):
        assert tuple(got.shape) == want.shape
        _close(got, want, LAYER_TOL)


def test_attn_params_have_the_reference_layout_and_scales():
    cfg = get_smoke_config("qwen2-0.5b").replace(d_model=256, n_layers=4)
    got = attn.attn_params(torch.Generator().manual_seed(0), cfg, torch.float32, lead=(3,))
    want = jax.vmap(lambda k: ref_attn.attn_params(k, cfg, jnp.float32))(
        jax.random.split(jax.random.PRNGKey(0), 3))
    shapes = lambda t: {k: shapes(v) if isinstance(v, dict) else tuple(v.shape)
                        for k, v in t.items()}
    assert shapes(got) == shapes(want)
    assert all(not bool(got[b].any()) for b in ("bq", "bk", "bv"))
    # the reference's std: 1/sqrt(d_in), wo also 1/sqrt(n_layers)
    assert abs(float(got["wq"].std()) * cfg.d_model ** 0.5 - 1) < 0.05
    H_dh = cfg.n_heads * cfg.dh
    assert abs(float(got["wo"].std()) * (H_dh * cfg.n_layers) ** 0.5 - 1) < 0.05


# ------------------------------------------------------------ attention

@pytest.mark.parametrize("groups", [1, 2, 4])
@pytest.mark.parametrize("prefix_len", [0, 3])
@pytest.mark.parametrize("causal", [True, False])
def test_full_attention_matches_reference(groups, prefix_len, causal):
    KVH = 2
    arrays = _qkv_arrays(10 + groups, 2, 9, 9, KVH * groups, KVH, 16)
    (qj, kj, vj), (qt, kt, vt) = _both(arrays)
    pos = np.arange(9, dtype=np.int32) + 2
    got = attn.full_attention(qt, kt, vt, causal=causal, q_pos=torch.from_numpy(pos),
                              kv_pos=torch.from_numpy(pos), prefix_len=prefix_len)
    want = ref_attn.full_attention(qj, kj, vj, causal=causal, q_pos=jnp.asarray(pos),
                                   kv_pos=jnp.asarray(pos), prefix_len=prefix_len)
    assert got.shape == want.shape
    _close(got, want, ATTN_TOL)


def test_full_attention_default_positions_and_cross_lengths():
    (qj, kj, vj), (qt, kt, vt) = _both(_qkv_arrays(4, 1, 5, 11, 4, 2, 16))
    _close(attn.full_attention(qt, kt, vt, causal=False),
           ref_attn.full_attention(qj, kj, vj, causal=False), ATTN_TOL)
    _close(attn.full_attention(qt[:, :5], kt[:, :5], vt[:, :5]),
           ref_attn.full_attention(qj[:, :5], kj[:, :5], vj[:, :5]), ATTN_TOL)


@pytest.mark.parametrize("Skv,block_kv", [(37, 16), (50, 8), (20, 32), (33, 11)])
@pytest.mark.parametrize("causal,prefix_len", [(True, 0), (True, 5), (False, 0)])
def test_blockwise_attention_matches_reference(Skv, block_kv, causal, prefix_len):
    arrays = _qkv_arrays(Skv, 2, Skv, Skv, 4, 2, 16)
    (qj, kj, vj), (qt, kt, vt) = _both(arrays)
    got = attn.blockwise_attention(qt, kt, vt, causal=causal, block_kv=block_kv,
                                   prefix_len=prefix_len)
    want = ref_attn.blockwise_attention(qj, kj, vj, causal=causal, block_kv=block_kv,
                                        prefix_len=prefix_len)
    assert got.dtype == torch.float32
    _close(got, want, ATTN_TOL)
    # and the port's own two routes agree
    full = attn.full_attention(qt, kt, vt, causal=causal, prefix_len=prefix_len)
    torch.testing.assert_close(got, full, rtol=ATTN_TOL, atol=ATTN_TOL)


def test_blockwise_attention_with_fewer_queries_than_keys():
    (qj, kj, vj), (qt, kt, vt) = _both(_qkv_arrays(8, 1, 6, 21, 2, 1, 16))
    _close(attn.blockwise_attention(qt, kt, vt, causal=False, block_kv=8),
           ref_attn.blockwise_attention(qj, kj, vj, causal=False, block_kv=8), ATTN_TOL)


@pytest.mark.parametrize("pos", [0, 3, 8, 11])
@pytest.mark.parametrize("groups", [1, 4])
def test_decode_attention_matches_reference(pos, groups):
    (qj, kj, vj), (qt, kt, vt) = _both(_qkv_arrays(pos, 2, 1, 12, 2 * groups, 2, 16))
    got = attn.decode_attention(qt, kt, vt, torch.tensor(pos, dtype=torch.int32))
    want = ref_attn.decode_attention(qj, kj, vj, jnp.int32(pos))
    _close(got, want, ATTN_TOL)
    # slots past pos do not count
    kt2, vt2 = kt.clone(), vt.clone()
    kt2[:, pos + 1:] = 9.0
    vt2[:, pos + 1:] = -9.0
    assert torch.equal(attn.decode_attention(qt, kt2, vt2, torch.tensor(pos, dtype=torch.int32)),
                       got)


@pytest.mark.parametrize("pos", [2, 11])
def test_bfloat16_attention_rounds_where_the_reference_does(pos):
    (qj, kj, vj), (qt, kt, vt) = _both(_qkv_arrays(30 + pos, 2, 12, 12, 4, 2, 16), "bfloat16")
    got = attn.decode_attention(qt[:, :1].float(), kt, vt, torch.tensor(pos, dtype=torch.int32))
    want = ref_attn.decode_attention(qj[:, :1].astype(jnp.float32), kj, vj, jnp.int32(pos))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(got), np.asarray(want, np.float32))
    got = attn.full_attention(qt, kt, vt)
    want = ref_attn.full_attention(qj, kj, vj)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), rtol=BF16_RTOL,
                               atol=BF16_RTOL)
    got = attn.blockwise_attention(qt, kt, vt, block_kv=5)
    want = ref_attn.blockwise_attention(qj, kj, vj, block_kv=5)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), rtol=BF16_RTOL,
                               atol=BF16_RTOL)


@pytest.mark.parametrize("S,full_thresh", [(9, 2048), (9, 4)])
def test_attention_block_matches_reference_on_both_routes(S, full_thresh):
    cfg = ref_smoke("deepseek-7b")
    ref_p = ref_attn.attn_params(jax.random.PRNGKey(9), cfg, jnp.float32)
    p = model.params_from_numpy(jax.tree.map(np.asarray, ref_p), "cpu")
    x = np.random.default_rng(S).normal(0, 1, (2, S, cfg.d_model)).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)
    got = attn.attention_block(cfg, p, torch.from_numpy(x), positions=torch.from_numpy(pos),
                               block_kv=4, full_thresh=full_thresh)
    want = ref_attn.attention_block(cfg, ref_p, jnp.asarray(x), positions=jnp.asarray(pos),
                                    block_kv=4, full_thresh=full_thresh)
    _close(got, want, ATTN_TOL)


# ------------------------------------------------------------ int8 KV cache

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scale", [1.0, 1e-3, 300.0])
def test_q8_and_dq_give_the_reference_bits(dtype, scale):
    rng = np.random.default_rng(int(scale * 7) + len(dtype))
    x = (rng.normal(0, scale, (3, 17, 2, 16))).astype(np.float32)
    x[0, 0, 0] = 0.0                      # an all-zero head: scale 1e-8
    x[1, 2, 1, :4] = scale * np.array([0.5, -0.5, 1.5, -2.5]) / 127 * 4  # halves
    (xj,), (xt,) = _both([x], dtype)
    qt, st = port_cache._q8(xt)
    qj, sj = ref_cache._q8(xj)
    assert qt.dtype == torch.int8 and st.dtype == torch.bfloat16
    assert tuple(st.shape) == (3, 17, 2, 1)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(_np(st), np.asarray(sj, np.float32))
    qj2, sj2 = jax.jit(ref_cache._q8)(xj)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj2))
    dt, dj = port_cache._dq(qt, st), ref_cache._dq(qj, sj)
    assert dt.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(dt), np.asarray(dj, np.float32))


def test_round_half_to_even():
    x = torch.tensor([0.5, 1.5, 2.5, -0.5, -1.5, -2.5])
    np.testing.assert_array_equal(torch.round(x).numpy(),
                                  np.asarray(jnp.round(jnp.asarray(x.numpy()))))


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "moonshot-v1-16b-a3b"])
def test_kv_dtype_is_the_compute_dtype(arch):
    for dt in ("float32", "bfloat16"):
        cfg = get_smoke_config(arch).replace(compute_dtype=dt)
        assert port_cache.kv_dtype(cfg) == layers.dtype_of(dt)
        assert jnp.dtype(ref_cache.kv_dtype(ref_smoke(arch).replace(compute_dtype=dt))).name \
            == str(port_cache.kv_dtype(cfg)).replace("torch.", "")

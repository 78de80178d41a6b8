"""The port's RWKV-6 serving path against the reference on the CPU: configs,
tokens, norms, the time-mix and channel-mix blocks, ``forward``,
``prefill``/``decode_step`` with their caches, and greedy ``generate``, on
``get_smoke_config("rwkv6-1.6b")`` (2 layers, d_model 64, 4 heads of 16,
vocab 512).  The reference's parameters (``jax.random``) go through
``params_from_numpy``, so both packages compute with the same weights.

Tolerances (float32 compute), against the reference's own bounds between its
routes (tests/test_models.py: prefill 2e-3, decode 5e-3):
- one block's outputs and states: rtol = atol = 1e-5 (1.4e-6 measured);
- prefill and decode logits and caches: rtol = atol = 1e-4 (1.2e-5
  measured over 4 decode steps); forward logits over 10 positions: 2e-4
  (3.8e-5 measured, logits up to ~4);
- greedy tokens, configs and ``make_batch`` tokens: identical.
bfloat16 compute (the config's own, which keeps ``wr`` float32 so that the
receptance product is float32): forward logits within atol = 0.15 (rtol 0)
and a mean |difference| below 0.016; prefill and decode logits equal to the
port's own forward.  XLA and torch round bfloat16 intermediates in different
places (XLA keeps some fused intermediates in float32), so the two differ by
about what bfloat16 costs either of them: measured 0.117 max and 0.0125 mean
at logits up to ~4 (about 4 bfloat16 ulps there).  Two faulty ports read, on
these inputs: the whole model in float32 0.231 / 0.0209 (the reference's own
bfloat16-to-float32 gap), ``r`` in bfloat16 0.328 / 0.0218; the bounds lie
between.  On 9 other pairs of parameter and token seeds the sound readings
span 0.078-0.445 / 0.010-0.021 and overlap the faulty ones, so this
comparison alone cannot tell them apart: ``test_bfloat16_dtype_flow`` holds
the dtypes that decide it, and chip_smoke.py holds the card's bfloat16
logits to the CPU port's at full width.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import base as ref_base
from repro.configs.registry import ARCH_IDS as REF_ARCH_IDS
from repro.configs.registry import get_config as ref_get_config
from repro.data.pipeline import make_batch as ref_make_batch
from repro.launch.serve import generate as ref_generate
from repro.models import cache as ref_cache
from repro.models import layers as ref_layers
from repro.models import model as ref_model
from repro.models import rwkv6 as ref_rwkv6
from repro_torch.configs import base as port_base
from repro_torch.configs.registry import ARCH_IDS, get_config, get_smoke_config
from repro_torch.data.pipeline import make_batch
from repro_torch.launch import steps
from repro_torch.launch.serve import generate, main
from repro_torch.models import cache as port_cache
from repro_torch.models import layers as port_layers
from repro_torch.models import model as port_model
from repro_torch.models import rwkv6 as port_rwkv6

ARCH = "rwkv6-1.6b"
BLOCK_TOL = 1e-5
LOGIT_TOL = 1e-4
FORWARD_TOL = 2e-4
BF16_ATOL, BF16_MEAN = 0.15, 0.016


@pytest.fixture(scope="module")
def smoke():
    cfg = get_smoke_config(ARCH)
    params = ref_model.init_params(jax.random.PRNGKey(3), cfg)
    return cfg, params, port_model.params_from_numpy(
        jax.tree.map(np.asarray, params), "cpu")


def _np(t):
    return t.detach().float().numpy()


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _close_bf16(got, want):
    diff = np.abs(_np(got) - np.asarray(want, np.float32))
    assert diff.max() <= BF16_ATOL and diff.mean() < BF16_MEAN, \
        (diff.max(), diff.mean())


# ------------------------------------------------------------ configs, data

def test_config_equals_reference_field_by_field():
    # the reference's ten archs, in its order
    assert ARCH_IDS == REF_ARCH_IDS
    ref = ref_get_config(ARCH)
    assert dataclasses.asdict(get_config(ARCH)) == dataclasses.asdict(ref)
    assert dataclasses.asdict(get_smoke_config(ARCH)) == \
        dataclasses.asdict(ref_base.smoke_reduce(ref))
    assert {k: dataclasses.asdict(v) for k, v in port_base.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in ref_base.SHAPES.items()}
    cfg = get_config(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab_size,
            cfg.rwkv_heads, cfg.rwkv_decay_lora) == (24, 2048, 7168, 65536, 32, 64)


@pytest.mark.parametrize("arch", ["paligemma-3b", "jamba-1.5-large-398b", "nope"])
def test_registry_lists_only_ported_archs(arch):
    """Every arch of the reference is ported; an unknown one raises."""
    if arch == "nope":
        with pytest.raises(KeyError, match="unknown arch 'nope'"):
            get_config(arch)
        return
    assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(ref_get_config(arch))
    assert dataclasses.asdict(get_smoke_config(arch)) == \
        dataclasses.asdict(ref_base.smoke_reduce(ref_get_config(arch)))


@pytest.mark.parametrize("batch,seq,seed,step,shard,n_shards",
                         [(8, 512, 0, 0, 0, 1), (2, 16, 1, 0, 0, 1),
                          (4, 33, 3, 7, 1, 2)])
def test_make_batch_tokens_are_the_reference_bits(batch, seq, seed, step, shard,
                                                  n_shards):
    cfg = get_config(ARCH)
    got = make_batch(cfg, batch, seq, seed=seed, step=step, shard=shard,
                     n_shards=n_shards)
    want = ref_make_batch(ref_get_config(ARCH), batch, seq, seed=seed, step=step,
                          shard=shard, n_shards=n_shards)
    assert got.keys() == want.keys()
    assert got["tokens"].dtype == want["tokens"].dtype
    np.testing.assert_array_equal(got["tokens"], want["tokens"])


# ------------------------------------------------------------ layers, params

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norms_match_reference(dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(0, 2.0, (3, 5, 64)).astype(np.float32)
    scale, bias = (rng.normal(0, 0.1, 64).astype(np.float32) for _ in range(2))
    xj = jnp.asarray(x).astype(ref_layers.dtype_of(dtype))
    xt = torch.from_numpy(x).to(port_layers.dtype_of(dtype))
    tol = 1e-6 if dtype == "float32" else 1e-2
    rms = port_layers.rmsnorm(xt, torch.from_numpy(scale))
    assert rms.dtype == xt.dtype
    _close(rms, ref_layers.rmsnorm(xj, jnp.asarray(scale)), tol)
    _close(port_layers.layernorm(xt, torch.from_numpy(scale), torch.from_numpy(bias)),
           ref_layers.layernorm(xj, jnp.asarray(scale), jnp.asarray(bias)), tol)


def test_init_params_has_the_reference_layout(smoke):
    cfg, ref_params, _ = smoke
    got = port_model.init_params(0, cfg, device="cpu")
    want = jax.tree.map(np.asarray, ref_params)

    def layout(tree):
        if isinstance(tree, dict):
            return {k: layout(v) for k, v in tree.items()}
        return tuple(tree.shape), str(tree.dtype).replace("torch.", "")

    assert layout(got) == layout(want)
    again = port_model.init_params(0, cfg, device="cpu")
    assert torch.equal(got["layers"]["wk"], again["layers"]["wk"])
    assert not torch.equal(got["layers"]["wk"][0], got["layers"]["wk"][1])
    # the reference's distributions: std 1/sqrt(d_in) weights, 0.02 embeddings
    assert abs(float(got["layers"]["wck"].std()) * cfg.d_model ** 0.5 - 1) < 0.05
    assert abs(float(got["embed"]["tok"].std()) / 0.02 - 1) < 0.05


def test_params_from_numpy_carries_values_and_bfloat16(smoke):
    _, ref_params, port_params = smoke
    np.testing.assert_array_equal(port_params["layers"]["wv"].numpy(),
                                  np.asarray(ref_params["layers"]["wv"]))
    bf = jnp.asarray(np.linspace(-3, 3, 12, dtype=np.float32)).astype(jnp.bfloat16)
    got = port_model.params_from_numpy({"a": {"w": np.asarray(bf)}}, "cpu")["a"]["w"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(bf, np.float32))


def test_cast_params_keeps_fp32_leaves_and_is_idempotent(smoke):
    cfg, _, params = smoke
    bf = cfg.replace(compute_dtype="bfloat16")
    once = port_model.cast_params(params, bf)
    assert once["layers"]["wr"].dtype == torch.float32
    assert once["layers"]["u"].dtype == torch.float32
    assert once["layers"]["ln_t"]["scale"].dtype == torch.float32
    assert once["layers"]["wk"].dtype == torch.bfloat16
    assert once["embed"]["tok"].dtype == torch.bfloat16
    twice = port_model.cast_params(once, bf)
    flat = lambda t: [t] if not isinstance(t, dict) else [x for v in t.values() for x in flat(v)]
    assert all(a is b for a, b in zip(flat(once), flat(twice)))
    assert all(a is b for a, b in zip(flat(params), flat(port_model.cast_params(params, cfg))))


def test_other_families_raise(smoke):
    """Every family of the reference is ported; one it does not know raises."""
    cfg = smoke[0].replace(family="nope")
    for call in (lambda: port_model.init_params(0, cfg, device="cpu"),
                 lambda: port_cache.init_cache(cfg, 1, device="cpu"),
                 lambda: port_model.forward(cfg, smoke[2], {"tokens": np.zeros((1, 2))})):
        with pytest.raises(ValueError, match="unknown family 'nope'"):
            call()


# ------------------------------------------------------------ the block

@pytest.mark.parametrize("with_state", [False, True])
def test_time_mix_and_channel_mix_match_reference(smoke, with_state):
    cfg, ref_params, port_params = smoke
    lj = jax.tree.map(lambda a: a[1], ref_params["layers"])
    lt = port_model._layer_slice(port_params["layers"], 1)
    rng = np.random.default_rng(11)
    B, S, D = 2, 7, cfg.d_model
    H, dh = cfg.rwkv_heads, cfg.rwkv_head_dim
    x = rng.normal(0, 1.0, (B, S, D)).astype(np.float32)
    state = None
    if with_state:
        state = {"shift_t": rng.normal(0, 1, (B, 1, D)).astype(np.float32),
                 "shift_c": rng.normal(0, 1, (B, 1, D)).astype(np.float32),
                 "wkv": rng.normal(0, 0.5, (B, H, dh, dh)).astype(np.float32)}
    sj = None if state is None else {k: jnp.asarray(v) for k, v in state.items()}
    st = None if state is None else {k: torch.from_numpy(v) for k, v in state.items()}
    oj, nj = ref_rwkv6.rwkv_time_mix(cfg, lj, jnp.asarray(x), sj)
    ot, nt = port_rwkv6.rwkv_time_mix(cfg, lt, torch.from_numpy(x), st)
    _close(ot, oj, BLOCK_TOL)
    for key in ("shift_t", "wkv"):
        assert nt[key].dtype == torch.float32
        _close(nt[key], nj[key], BLOCK_TOL)
    cj, cnj = ref_rwkv6.rwkv_channel_mix(cfg, lj, jnp.asarray(x), sj)
    ct, cnt = port_rwkv6.rwkv_channel_mix(cfg, lt, torch.from_numpy(x), st)
    _close(ct, cj, BLOCK_TOL)
    _close(cnt["shift_c"], cnj["shift_c"], BLOCK_TOL)
    init = port_rwkv6.rwkv_init_state(cfg, B, device="cpu")
    want = ref_rwkv6.rwkv_init_state(cfg, B)
    assert {k: tuple(v.shape) for k, v in init.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}


# ------------------------------------------------------------ the model

def test_forward_prefill_and_decode_match_reference(smoke):
    cfg, ref_params, port_params = smoke
    toks = ref_make_batch(cfg, 2, 10, seed=3, step=0)["tokens"][:, :-1]
    full_j, _ = ref_model.forward(cfg, ref_params, {"tokens": toks})
    full_t, aux = port_model.forward(cfg, port_params, {"tokens": torch.from_numpy(toks)})
    assert full_t.shape == (2, 10, cfg.vocab_size) and float(aux) == 0.0
    _close(full_t, full_j, FORWARD_TOL)

    lj, cj = ref_cache.prefill(cfg, ref_params, {"tokens": toks[:, :6]}, max_seq=10)
    lt, ct = port_cache.prefill(cfg, port_params, {"tokens": torch.from_numpy(toks[:, :6])})
    assert lt.shape == (2, 1, cfg.vocab_size)
    _close(lt, lj, LOGIT_TOL)
    for t in range(6, 10):
        assert int(ct["pos"]) == int(cj["pos"]) == t
        assert ct["pos"].dtype == torch.int32
        for key in ("shift_t", "shift_c", "wkv"):
            assert ct[key].shape == cj[key].shape
            _close(ct[key], cj[key], LOGIT_TOL)
        lj, cj = ref_cache.decode_step(cfg, ref_params, cj, toks[:, t:t + 1])
        lt, ct = port_cache.decode_step(cfg, port_params, ct, torch.from_numpy(toks[:, t:t + 1]))
        _close(lt, lj, LOGIT_TOL)
    init = port_cache.init_cache(cfg, 2, device="cpu")
    want = ref_cache.init_cache(cfg, 2, 10)
    assert {k: (tuple(v.shape), str(v.dtype).replace("torch.", "")) for k, v in init.items()} \
        == {k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()}


def test_decode_matches_full_forward(smoke):
    """The port against itself, as tests/test_models.py holds the reference:
    prefill 6 tokens, decode 4, against teacher-forced ``forward``."""
    cfg, _, params = smoke
    toks = torch.from_numpy(make_batch(cfg, 1, 10, seed=3, step=0)["tokens"][:, :-1])
    full, _ = port_model.forward(cfg, params, {"tokens": toks})
    logits, cache = port_cache.prefill(cfg, params, {"tokens": toks[:, :6]})
    torch.testing.assert_close(logits[0, -1], full[0, 5], rtol=LOGIT_TOL, atol=LOGIT_TOL)
    for t in range(6, 10):
        logits, cache = port_cache.decode_step(cfg, params, cache, toks[:, t:t + 1])
        torch.testing.assert_close(logits[0, -1], full[0, t], rtol=LOGIT_TOL,
                                   atol=LOGIT_TOL)


def test_decode_step_leaves_the_callers_cache(smoke):
    cfg, _, params = smoke
    toks = torch.from_numpy(make_batch(cfg, 2, 5, seed=1, step=0)["tokens"][:, :-1])
    _, cache = port_cache.prefill(cfg, params, {"tokens": toks})
    before = {k: v.clone() for k, v in cache.items()}
    nxt, new = steps.make_decode_step(cfg)(params, cache, {"tokens": toks[:, -1:]})
    assert nxt.dtype == torch.int32 and nxt.shape == (2,)
    assert all(torch.equal(cache[k], before[k]) for k in cache)
    assert int(new["pos"]) == 6


def test_generate_gives_the_reference_tokens(smoke):
    cfg, ref_params, port_params = smoke
    batch = ref_make_batch(cfg, 2, 12, seed=0, step=0)
    batch["tokens"] = batch["tokens"][:, :-1]
    want, _ = ref_generate(cfg, ref_params, batch, max_new=8)
    got, stats = generate(cfg, port_params, batch, max_new=8, device="cpu")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert set(stats) == {"prefill_s", "decode_s", "tok_per_s"}
    assert stats["tok_per_s"] > 0


def test_generate_refuses_params_on_another_device(smoke):
    cfg, _, params = smoke
    batch = {"tokens": np.zeros((1, 3), np.int32)}
    meta = port_model.params_to(params, "meta")
    with pytest.raises(ValueError, match="params lie on"):
        generate(cfg, meta, batch, device="cpu")


def test_main_serves_the_smoke_config_on_the_cpu(capsys):
    stats = main(["--arch", ARCH, "--smoke", "--device", "cpu", "--tokens", "4"])
    assert stats["decode_s"] > 0
    assert "generated (2, 4)" in capsys.readouterr().out


def test_bfloat16_compute_matches_reference(smoke):
    """The config's own compute dtype: ``wr`` stays float32 (``_FP32_KEEP``),
    so the receptance product is bfloat16 @ float32, which JAX promotes to
    float32 and the port computes as ``xr.float() @ wr``."""
    cfg, ref_params, port_params = smoke
    bf = cfg.replace(compute_dtype="bfloat16")
    toks = ref_make_batch(bf, 2, 10, seed=3, step=0)["tokens"][:, :-1]
    full_j, _ = ref_model.forward(bf, ref_params, {"tokens": toks})
    full_t, _ = port_model.forward(bf, port_params, {"tokens": torch.from_numpy(toks)})
    assert full_t.dtype == torch.bfloat16
    _close_bf16(full_t, full_j)
    lj, cj = ref_cache.prefill(bf, ref_params, {"tokens": toks[:, :6]})
    lt, ct = port_cache.prefill(bf, port_params, {"tokens": torch.from_numpy(toks[:, :6])})
    _close_bf16(lt, lj)
    assert torch.equal(lt[:, -1], full_t[:, 5])
    lj, _ = ref_cache.decode_step(bf, ref_params, cj, toks[:, 6:7])
    lt, _ = port_cache.decode_step(bf, port_params, ct, torch.from_numpy(toks[:, 6:7]))
    _close_bf16(lt, lj)
    assert torch.equal(lt[:, -1], full_t[:, 6])


def test_bfloat16_dtype_flow(smoke, monkeypatch):
    """The dtypes of the reference's bfloat16 compute (rwkv6.py:84-99):
    ``r`` float32 (bfloat16 @ float32 ``wr``), ``k`` and ``v`` bfloat16,
    ``wlog`` float32 (``w0`` + a bfloat16 LoRA), the block's output and
    the logits bfloat16, the carried states float32."""
    cfg, _, params = smoke
    bf = cfg.replace(compute_dtype="bfloat16")
    seen, kernel = [], port_rwkv6.wkv6

    def spy(r, k, v, wlog, u, init_state=None):
        seen.append((r.dtype, k.dtype, v.dtype, wlog.dtype, u.dtype))
        return kernel(r, k, v, wlog, u, init_state)

    monkeypatch.setattr(port_rwkv6, "wkv6", spy)
    toks = torch.from_numpy(make_batch(bf, 2, 5, seed=1, step=0)["tokens"][:, :-1])
    logits, cache = port_cache.prefill(bf, params, {"tokens": toks})
    f32, b16 = torch.float32, torch.bfloat16
    assert seen == [(f32, b16, b16, f32, f32)] * cfg.n_layers
    assert logits.dtype == b16
    assert all(cache[k].dtype == f32 for k in ("shift_t", "shift_c", "wkv"))
    lp = port_model._layer_slice(port_model.cast_params(params, bf)["layers"], 0)
    out, _ = port_rwkv6.rwkv_time_mix(bf, lp, torch.zeros((1, 2, cfg.d_model), dtype=b16))
    assert out.dtype == b16

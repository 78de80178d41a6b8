"""The port's dense and MoE model families against the reference on the CPU,
for each of the six archs on its smoke config (2 layers, d_model 64, 4
heads of 16, vocab 512; MoE: 8 experts, top 2), float32 compute: configs,
``init_params`` / ``init_cache`` layouts, ``forward``, ``prefill`` and 4
``decode_step``s with and without the int8 KV cache, the port's decode
against its own teacher-forced ``forward``, greedy ``generate``, ``loss_fn``
and every gradient leaf, three train steps, bfloat16 compute, and the
``launch.serve`` / ``launch.train`` entry points.  The reference's parameters
(``jax.random``) go through ``params_from_numpy``.

Tolerances (float32 compute):
- ``forward`` logits: rtol = atol = 2e-4 (FORWARD_TOL; 3.2e-6 measured);
- prefill and decode logits and caches: rtol = atol = 1e-4 (LOGIT_TOL;
  3.2e-6 measured); int8 caches: identical bits;
- the port's decode against its own ``forward``: 2e-4 / 2e-3
  (tests/test_models.py's bounds for the reference);
- greedy tokens, routing and configs: identical;
- loss rtol 1e-6, each gradient leaf within 2e-4 of its largest |reference
  gradient| (1.3e-6 measured); three train steps: loss, gnorm, lr rtol 1e-5,
  parameters atol 2e-5, moments within 2e-4 of the leaf's largest
  (tests/test_torch_train.py's bounds; 7e-7, 2.5e-6, 2.4e-6 measured).

The int8 cache (``kv_quant``) is held to the reference run op by op
(``jax.disable_jit``).  The reference's int8 path casts the attention output
to bfloat16 (``decode_attention``'s ``astype(v_cache.dtype)``), and so does
the port; under ``jit`` XLA keeps that intermediate in float32 (its excess
precision), so the jitted reference sits up to 0.024 from its own op-by-op
run on these configs, and the port with it.  Op by op, both round where the
source says and agree within 3.2e-6 with identical int8 caches.

bfloat16 compute: XLA and torch round bfloat16 intermediates in other
places, so the port is held to the reference's op-by-op run no farther than
1.25 times the reference's own jitted run sits from it, in max and in mean
(measured at most 0.82x and 0.88x; 0.031 / 0.039 at logits up to ~4).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs.registry import get_config as ref_get_config
from repro.configs.registry import get_smoke_config as ref_smoke
from repro.launch import steps as ref_steps
from repro.launch.serve import generate as ref_generate
from repro.launch.train import main as ref_train_main
from repro.models import cache as ref_cache
from repro.models import model as ref_model
from repro.optim.optimizers import get_optimizer as ref_get_optimizer
from repro_torch.configs.registry import ARCH_IDS, get_config, get_smoke_config
from repro_torch.data.pipeline import make_batch
from repro_torch.launch import steps
from repro_torch.launch import train as train_mod
from repro_torch.launch.serve import generate
from repro_torch.launch.serve import main as serve_main
from repro_torch.models import cache as port_cache
from repro_torch.models import model
from repro_torch.optim import get_optimizer
from repro_torch.tree import tree_leaves, tree_map

ARCHS = ("kimi-k2-1t-a32b", "moonshot-v1-16b-a3b", "deepseek-7b", "internlm2-20b",
         "qwen2-0.5b", "qwen2.5-3b")
FORWARD_TOL, LOGIT_TOL = 2e-4, 1e-4
TF_PREFILL_TOL, TF_DECODE_TOL = 2e-4, 2e-3
LOSS_TOL, GRAD_TOL = 1e-6, 2e-4
STEP_TOL, PARAM_ATOL, MOMENT_TOL = 1e-5, 2e-5, 2e-4
BF16_SPREAD = 1.25
PROMPT, DECODE = 8, 4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_SMOKE = {}


def smoke(arch):
    """(cfg, the reference's parameters, the same as the port's)."""
    if arch not in _SMOKE:
        cfg = get_smoke_config(arch)
        params = ref_model.init_params(jax.random.PRNGKey(3), cfg)
        _SMOKE[arch] = (cfg, params, model.params_from_numpy(
            jax.tree.map(np.asarray, params), "cpu"))
    return _SMOKE[arch]


def _np(t):
    return t.detach().float().numpy()


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), rtol=tol, atol=tol,
                               err_msg=what)


def _leaf_scaled(got, want, tol, what):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=tol * max(float(np.abs(want).max()), 1e-30), err_msg=what)


def _layout(tree):
    if isinstance(tree, dict):
        return {k: _layout(v) for k, v in tree.items()}
    return tuple(tree.shape), str(tree.dtype).replace("torch.", "")


def _tokens(cfg, B, S, seed):
    return make_batch(cfg, B, S, seed=seed, step=0)["tokens"][:, :-1]


# ------------------------------------------------------------ configs, layout

@pytest.mark.parametrize("arch", ARCHS)
def test_config_equals_reference_field_by_field(arch):
    assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(ref_get_config(arch))
    assert dataclasses.asdict(get_smoke_config(arch)) == dataclasses.asdict(ref_smoke(arch))


def test_registry_lists_the_ported_archs_in_the_reference_order():
    from repro.configs.registry import ARCH_IDS as REF_IDS
    assert ARCH_IDS == REF_IDS
    assert set(ARCHS) < set(ARCH_IDS)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_has_the_reference_layout(arch):
    cfg, ref_params, _ = smoke(arch)
    got = model.init_params(0, cfg, device="cpu")
    assert _layout(got) == _layout(jax.tree.map(np.asarray, ref_params))
    assert ("moe" in got["layers"]) == bool(cfg.n_experts)
    assert ("lm_head" in got) == (not cfg.tie_embeddings)
    again = model.init_params(0, cfg, device="cpu")
    wq = got["layers"]["attn"]["wq"]
    assert torch.equal(wq, again["layers"]["attn"]["wq"]) and not torch.equal(wq[0], wq[1])
    full = ref_get_config(arch)
    if full.param_dtype == "bfloat16":     # kimi: bfloat16 parameters, a float32 router
        bf = model.init_params(0, cfg.replace(param_dtype="bfloat16"), device="cpu")
        assert bf["layers"]["moe"]["wei"].dtype == torch.bfloat16
        assert bf["layers"]["moe"]["wr"].dtype == torch.float32


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kv_quant", [False, True])
def test_init_cache_has_the_reference_layout(arch, kv_quant):
    cfg = get_smoke_config(arch).replace(kv_quant=kv_quant)
    got = port_cache.init_cache(cfg, 2, 24, device="cpu")
    want = ref_cache.init_cache(ref_smoke(arch).replace(kv_quant=kv_quant), 2, 24)
    assert _layout(got) == _layout(jax.tree.map(np.asarray, want))
    assert all(not bool(v.any()) for v in got.values())
    with pytest.raises(ValueError, match="max_seq"):
        port_cache.init_cache(cfg, 2, device="cpu")


def test_cast_params_casts_the_qkv_biases_and_keeps_the_router():
    cfg, _, params = smoke("qwen2-0.5b")
    bf = model.cast_params(params, cfg.replace(compute_dtype="bfloat16"))
    assert all(bf["layers"]["attn"][b].dtype == torch.bfloat16 for b in ("bq", "bk", "bv"))
    assert bf["layers"]["attn"]["ln"]["scale"].dtype == torch.float32
    cfg, _, params = smoke("moonshot-v1-16b-a3b")
    bf = model.cast_params(params, cfg.replace(compute_dtype="bfloat16"))
    assert bf["layers"]["moe"]["wr"].dtype == torch.float32
    assert bf["layers"]["moe"]["weg"].dtype == torch.bfloat16


# ------------------------------------------------------------ serving

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    cfg, ref_params, params = smoke(arch)
    toks = _tokens(cfg, 2, 12, seed=3)
    want, want_aux = ref_model.forward(cfg, ref_params, {"tokens": toks})
    got, aux = model.forward(cfg, params, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (2, 12, cfg.vocab_size) and aux.dtype == torch.float32
    _close(got, want, FORWARD_TOL)
    _close(aux, want_aux, LOSS_TOL)
    assert (float(aux) > 0) == bool(cfg.n_experts)


def _prefill_decode(cfg, ref_params, params, toks, op_by_op):
    """Prefill PROMPT tokens then decode DECODE, in both packages; returns
    the (port, reference) logits and caches after each step."""
    def ref(fn, *a, **kw):
        if op_by_op:
            with jax.disable_jit():
                return fn(*a, **kw)
        return fn(*a, **kw)

    S = toks.shape[1]
    lj, cj = ref(ref_cache.prefill, cfg, ref_params, {"tokens": toks[:, :PROMPT]}, max_seq=S)
    lt, ct = port_cache.prefill(cfg, params, {"tokens": torch.from_numpy(toks[:, :PROMPT])},
                                max_seq=S)
    out = [(lt, lj, ct, cj)]
    for t in range(PROMPT, S):
        lj, cj = ref(ref_cache.decode_step, cfg, ref_params, cj, toks[:, t:t + 1])
        lt, ct = port_cache.decode_step(cfg, params, ct, torch.from_numpy(toks[:, t:t + 1]))
        out.append((lt, lj, ct, cj))
    return out


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kv_quant", [False, True])
def test_prefill_and_decode_match_reference(arch, kv_quant):
    cfg, ref_params, params = smoke(arch)
    cfg = cfg.replace(kv_quant=kv_quant)
    toks = _tokens(cfg, 2, PROMPT + DECODE, seed=3)
    for i, (lt, lj, ct, cj) in enumerate(_prefill_decode(cfg, ref_params, params, toks,
                                                         op_by_op=kv_quant)):
        assert lt.shape == (2, 1, cfg.vocab_size)
        _close(lt, lj, LOGIT_TOL, f"logits after step {i}")
        assert ct["pos"].dtype == torch.int32 and int(ct["pos"]) == int(cj["pos"]) == PROMPT + i
        assert set(ct) == set(cj)
        for key in ct:
            if kv_quant:
                np.testing.assert_array_equal(_np(ct[key]), np.asarray(cj[key], np.float32),
                                              err_msg=key)
            else:
                _close(ct[key], cj[key], LOGIT_TOL, key)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_own_forward(arch):
    """The port against itself, as tests/test_models.py holds the reference:
    prefill 8 tokens, decode 4, against teacher-forced ``forward``.  An MoE
    layer drops the assignments past an expert's capacity, which depends on
    how many tokens a call routes (12 in ``forward``, 2 in a decode step), so
    the MoE archs run here at a capacity factor that keeps every assignment
    (C = T); their drops are held to the reference's in
    ``test_forward_matches_reference`` and tests/test_torch_moe.py."""
    cfg, _, params = smoke(arch)
    if cfg.n_experts:
        cfg = cfg.replace(capacity_factor=cfg.n_experts / cfg.experts_per_token)
    toks = torch.from_numpy(_tokens(cfg, 1, 12, seed=2))
    full, _ = model.forward(cfg, params, {"tokens": toks})
    logits, cache = port_cache.prefill(cfg, params, {"tokens": toks[:, :8]}, max_seq=12)
    torch.testing.assert_close(logits[0, -1], full[0, 7], rtol=TF_PREFILL_TOL,
                               atol=TF_PREFILL_TOL)
    for t in range(8, 12):
        logits, cache = port_cache.decode_step(cfg, params, cache, toks[:, t:t + 1])
        torch.testing.assert_close(logits[0, -1], full[0, t], rtol=TF_DECODE_TOL,
                                   atol=TF_DECODE_TOL)


@pytest.mark.parametrize("kv_quant", [False, True])
def test_decode_step_leaves_the_callers_cache(kv_quant):
    cfg, _, params = smoke("qwen2-0.5b")
    cfg = cfg.replace(kv_quant=kv_quant)
    toks = torch.from_numpy(_tokens(cfg, 2, 5, seed=1))
    _, cache = port_cache.prefill(cfg, params, {"tokens": toks}, max_seq=9)
    before = {k: v.clone() for k, v in cache.items()}
    nxt, new = steps.make_decode_step(cfg)(params, cache, {"tokens": toks[:, -1:]})
    assert nxt.dtype == torch.int32 and nxt.shape == (2,)
    assert all(torch.equal(cache[k], before[k]) for k in cache)
    assert int(new["pos"]) == 6 and bool(new["k"][:, :, 5].any())
    assert not bool(new["k"][:, :, 6:].any())


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_gives_the_reference_tokens(arch):
    cfg, ref_params, params = smoke(arch)
    batch = make_batch(cfg, 2, 12, seed=0, step=0)
    batch["tokens"] = batch["tokens"][:, :-1]
    want, _ = ref_generate(cfg, ref_params, batch, max_new=8)
    got, stats = generate(cfg, params, batch, max_new=8, device="cpu")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert stats["tok_per_s"] > 0


def test_generate_sizes_the_cache_to_the_prompt_and_the_new_tokens(monkeypatch):
    cfg, _, params = smoke("qwen2-0.5b")
    seen = []
    prefill = port_cache.prefill

    def spy(*a, **kw):
        seen.append(kw.get("max_seq"))
        return prefill(*a, **kw)

    monkeypatch.setattr(port_cache, "prefill", spy)
    generate(cfg, params, {"tokens": np.zeros((1, 5), np.int32)}, max_new=3, device="cpu")
    assert seen == [8]


@pytest.mark.parametrize("arch", ARCHS)
def test_bfloat16_compute_stays_within_the_references_own_spread(arch):
    cfg, ref_params, params = smoke(arch)
    bf = cfg.replace(compute_dtype="bfloat16")
    toks = _tokens(bf, 2, 12, seed=3)
    jitted, _ = ref_model.forward(bf, ref_params, {"tokens": toks})
    with jax.disable_jit():
        op_by_op, _ = ref_model.forward(bf, ref_params, {"tokens": toks})
    got, _ = model.forward(bf, params, {"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.bfloat16
    ref_gap = np.abs(np.asarray(jitted, np.float32) - np.asarray(op_by_op, np.float32))
    gap = np.abs(_np(got) - np.asarray(op_by_op, np.float32))
    assert gap.max() <= BF16_SPREAD * ref_gap.max(), (gap.max(), ref_gap.max())
    assert gap.mean() <= BF16_SPREAD * ref_gap.mean(), (gap.mean(), ref_gap.mean())
    # prefill gives the port's own forward's logits (MoE: keeping every
    # assignment, as the two route different numbers of tokens)
    if bf.n_experts:
        bf = bf.replace(capacity_factor=bf.n_experts / bf.experts_per_token)
        got, _ = model.forward(bf, params, {"tokens": torch.from_numpy(toks)})
    logits, cache = port_cache.prefill(bf, params, {"tokens": torch.from_numpy(toks[:, :8])},
                                       max_seq=12)
    assert cache["k"].dtype == torch.bfloat16
    assert torch.equal(logits[:, -1], got[:, 7])


# ------------------------------------------------------------ training

@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_match_reference(arch):
    cfg, ref_params, port_params = smoke(arch)
    batch = make_batch(cfg, 2, 24, seed=1, step=0)
    (want_loss, want_parts), want_grads = jax.jit(jax.value_and_grad(
        lambda p: ref_model.loss_fn(cfg, p, batch), has_aux=True))(ref_params)
    params = tree_map(lambda p: p.clone().requires_grad_(), port_params)
    loss, parts = model.loss_fn(cfg, params, batch)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=LOSS_TOL)
    np.testing.assert_allclose(float(parts["ce"].detach()), float(want_parts["ce"]),
                               rtol=LOSS_TOL)
    np.testing.assert_allclose(float(parts["aux"].detach()), float(want_parts["aux"]),
                               rtol=LOSS_TOL)
    flat = jax.tree_util.tree_flatten_with_path(want_grads)[0]
    leaves = tree_leaves(params)
    assert len(flat) == len(leaves)
    for (path, want), p in zip(flat, leaves):
        assert p.grad is not None and p.grad.dtype == p.dtype
        _leaf_scaled(p.grad, want, GRAD_TOL, jax.tree_util.keystr(path))


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "moonshot-v1-16b-a3b"])
def test_remat_changes_no_gradient(arch):
    cfg, _, port_params = smoke(arch)
    batch = make_batch(cfg, 2, 10, seed=3, step=0)
    grads = {}
    for remat in ("full", "none"):
        params = tree_map(lambda p: p.clone().requires_grad_(), port_params)
        model.loss_fn(cfg.replace(remat=remat), params, batch)[0].backward()
        grads[remat] = [p.grad for p in tree_leaves(params)]
    assert all(torch.equal(a, b) for a, b in zip(grads["full"], grads["none"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_three_train_steps_match_reference(arch):
    cfg, ref_params, port_params = smoke(arch)
    ref_step = jax.jit(ref_steps.make_train_step(cfg, warmup=1, base_lr=1e-3))
    port_step = steps.make_train_step(cfg, warmup=1, base_lr=1e-3)
    ref_opt = ref_get_optimizer(cfg.optimizer)
    rs = {"params": ref_params, "opt": ref_opt.init(ref_params),
          "step": jnp.zeros((), jnp.int32)}
    opt = get_optimizer(cfg.optimizer)
    ps = {"params": port_params, "opt": opt.init(port_params),
          "step": torch.zeros((), dtype=torch.int32)}
    for i in range(3):
        batch = make_batch(cfg, 2, 16, seed=2, step=i)
        rs, rm = ref_step(rs, batch)
        ps, pm = port_step(ps, batch)
        for k in ("loss", "ce", "aux", "gnorm", "lr"):
            np.testing.assert_allclose(float(pm[k]), float(rm[k]), rtol=STEP_TOL, err_msg=k)
    flat = jax.tree_util.tree_flatten_with_path(rs)[0]
    leaves = tree_leaves(ps)
    assert len(flat) == len(leaves)
    for (path, want), got in zip(flat, leaves):
        name = jax.tree_util.keystr(path)
        assert tuple(got.shape) == np.shape(want), name
        if name.startswith("['params']"):
            np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), rtol=0,
                                       atol=PARAM_ATOL, err_msg=name)
        elif name.startswith("['opt']"):
            _leaf_scaled(got, want, MOMENT_TOL, name)
        else:
            assert int(got) == int(want) == 3, name


# ------------------------------------------------------------ entry points

def test_serve_main_serves_the_dense_smoke_config_on_the_cpu(capsys):
    stats = serve_main(["--smoke", "--device", "cpu", "--tokens", "4"])
    assert stats["decode_s"] > 0
    assert "qwen2-0.5b: generated (2, 4)" in capsys.readouterr().out


def test_serve_main_serves_the_moe_smoke_config_on_the_cpu(capsys):
    serve_main(["--arch", "moonshot-v1-16b-a3b", "--smoke", "--device", "cpu",
                "--tokens", "3", "--batch", "3", "--prompt-len", "9"])
    assert "moonshot-v1-16b-a3b: generated (3, 3)" in capsys.readouterr().out


@pytest.fixture
def reference_init(monkeypatch):
    def init_params(seed, cfg, device=None):
        ref = ref_model.init_params(jax.random.PRNGKey(seed), cfg)
        return model.params_from_numpy(jax.tree.map(np.asarray, ref), device)
    monkeypatch.setattr(model, "init_params", init_params)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "moonshot-v1-16b-a3b"])
def test_train_main_matches_reference(arch, reference_init):
    flags = ["--arch", arch, "--smoke", "--steps", "4", "--batch", "2", "--seq", "16",
             "--log-every", "1"]
    want = ref_train_main(flags)
    got = train_mod.main(flags + ["--device", "cpu"])
    assert len(got["losses"]) == len(want["losses"]) == 4
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=STEP_TOL)


def test_train_main_defaults_to_qwen2(capsys):
    out = train_mod.main(["--smoke", "--steps", "2", "--batch", "2", "--seq", "8",
                          "--log-every", "1", "--device", "cpu"])
    assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))
    assert "done: 2 steps" in capsys.readouterr().out

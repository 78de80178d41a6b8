"""The port's vlm family (PaliGemma: patch embeddings in front of the text
under a prefix-LM mask, tied logits, gemma's scaled embeddings, a text-only
loss) against the reference on the CPU, on ``get_smoke_config(
"paligemma-3b")`` (2 layers, d_model 64, 4 heads of 16 with 1 KV head, GeGLU
d_ff 96, vocab 512, 8 patches), float32 compute: ``forward`` and the prefix
mask, ``loss_fn`` and every gradient leaf, ``prefill`` (``max_seq`` counting
the patches) with 4 ``decode_step``s, decode against the port's own
teacher-forced ``forward``, ``generate`` at ``max_new`` below and above the
patch count against the reference's prefill + decode loop at the cache size
that holds every position, three AdamW train steps and the entry points.
The reference's parameters go through ``params_from_numpy``; patches and
tokens come from ``make_batch`` (numpy, from a seed).

The reference's own ``generate`` sizes its cache S + max_new, short of the
patches (ROADMAP queue 3, watched): at ``max_new`` 4 its prefill raises, at
12 its last writes clamp onto the last slot.  The port's ``generate`` sizes
it patches + S + max_new, and is held to the reference's loop at that size.

Tolerances (float32), the dense family's (tests/test_torch_dense.py):
``forward`` logits 2e-4 (4.6e-7 measured), prefill / decode logits and
caches 1e-4 (2.1e-6 measured), decode against the port's own ``forward``
2e-4 / 2e-3, loss rtol 1e-6, gradient leaves 2e-4 of their largest (1.3e-6
measured), train steps rtol 1e-5 / parameters atol 2e-5 / moments 2e-4 of
their largest; greedy tokens and layouts identical; the bfloat16
embeddings identical.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.launch import steps as ref_steps
from repro.launch.serve import generate as ref_generate
from repro.models import cache as ref_cache
from repro.models import model as ref_model
from repro.optim.optimizers import get_optimizer as ref_get_optimizer
from repro_torch.configs.registry import get_smoke_config
from repro_torch.data.pipeline import make_batch
from repro_torch.launch import steps
from repro_torch.launch import train as train_mod
from repro_torch.launch.serve import generate
from repro_torch.launch.serve import main as serve_main
from repro_torch.models import cache as port_cache
from repro_torch.models import model
from repro_torch.optim import get_optimizer
from repro_torch.tree import tree_leaves, tree_map

ARCH = "paligemma-3b"
FORWARD_TOL, LOGIT_TOL = 2e-4, 1e-4
TF_PREFILL_TOL, TF_DECODE_TOL = 2e-4, 2e-3
LOSS_TOL, GRAD_TOL = 1e-6, 2e-4
STEP_TOL, PARAM_ATOL, MOMENT_TOL = 1e-5, 2e-5, 2e-4
DECODE = 4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def smoke():
    """(cfg, the reference's parameters, the same as the port's)."""
    cfg = get_smoke_config(ARCH)
    params = ref_model.init_params(jax.random.PRNGKey(3), cfg)
    return cfg, params, model.params_from_numpy(jax.tree.map(np.asarray, params), "cpu")


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


def _prompt(cfg, B, seq, seed):
    """make_batch's prompt: ``seq - 8`` text tokens (at least 8) after the
    8 patches; the last token dropped, as ``launch.serve`` does."""
    batch = make_batch(cfg, B, seq, seed=seed, step=0)
    batch["tokens"] = batch["tokens"][:, :-1]
    return batch


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# ------------------------------------------------------------ layout, embed

def test_layouts_match_reference(smoke):
    cfg, ref_params, _ = smoke
    got = model.init_params(0, cfg, device="cpu")
    assert _layout(got) == _layout(jax.tree.map(np.asarray, ref_params))
    assert "lm_head" not in got and got["layers"]["mlp"].keys() >= {"wg", "wi"}
    cache = port_cache.init_cache(cfg, 2, 24, device="cpu")
    assert _layout(cache) == _layout(jax.tree.map(np.asarray, ref_cache.init_cache(cfg, 2, 24)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embeddings_are_scaled_in_the_compute_dtype(smoke, dtype):
    cfg, ref_params, params = smoke
    c = cfg.replace(compute_dtype=dtype)
    toks = _prompt(cfg, 2, 16, seed=0)["tokens"]
    got = model._embed(c, model.cast_params(params, c), torch.from_numpy(toks))
    want = ref_model._embed(c, ref_model.cast_params(ref_params, c), toks)
    np.testing.assert_array_equal(_np(got), np.asarray(want, np.float32))


# ------------------------------------------------------------ forward, loss

def test_forward_matches_reference(smoke):
    cfg, ref_params, params = smoke
    batch = _prompt(cfg, 2, 20, seed=3)
    want, want_aux = ref_model.forward(cfg, ref_params, batch)
    got, aux = model.forward(cfg, params, _torch(batch))
    assert got.shape == (2, cfg.n_vision_tokens + 12, cfg.vocab_size)
    _close(got, want, FORWARD_TOL)
    assert float(aux) == float(want_aux) == 0.0


def test_the_prefix_is_bidirectional_and_the_text_causal(smoke):
    cfg, _, params = smoke
    batch = _torch(_prompt(cfg, 1, 20, seed=4))
    base, _ = model.forward(cfg, params, batch)
    last_patch = dict(batch, patches=batch["patches"].clone())
    last_patch["patches"][:, -1] += 1.0
    moved, _ = model.forward(cfg, params, last_patch)
    assert not torch.allclose(moved[:, 0], base[:, 0])   # patch 0 sees the last patch
    last_tok = dict(batch, tokens=batch["tokens"].clone())
    last_tok["tokens"][:, -1] = (last_tok["tokens"][:, -1] + 1) % cfg.vocab_size
    moved, _ = model.forward(cfg, params, last_tok)
    assert torch.equal(moved[:, :-1], base[:, :-1])   # nothing sees a later token
    assert not torch.equal(moved[:, -1], base[:, -1])


def test_text_only_loss_and_every_gradient_match_reference(smoke):
    cfg, ref_params, port_params = smoke
    batch = make_batch(cfg, 2, 24, seed=1, step=0)
    (want_loss, want_parts), want_grads = jax.jit(jax.value_and_grad(
        lambda p: ref_model.loss_fn(cfg, p, batch), has_aux=True))(ref_params)
    params = tree_map(lambda p: p.clone().requires_grad_(), port_params)
    loss, parts = model.loss_fn(cfg, params, batch)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=LOSS_TOL)
    np.testing.assert_allclose(float(parts["ce"].detach()), float(want_parts["ce"]),
                               rtol=LOSS_TOL)
    # the text positions only: the CE of the port's own logits sliced there
    with torch.no_grad():
        logits, _ = model.forward(cfg, port_params, {**_torch(batch), "tokens": torch.from_numpy(
            batch["tokens"][:, :-1])})
    text = logits[:, cfg.n_vision_tokens:]
    ce = torch.nn.functional.cross_entropy(text.reshape(-1, cfg.vocab_size),
                                           torch.from_numpy(batch["tokens"][:, 1:]).reshape(-1).long())
    np.testing.assert_allclose(float(ce), float(parts["ce"].detach()), rtol=1e-6)
    flat = jax.tree_util.tree_flatten_with_path(want_grads)[0]
    leaves = tree_leaves(params)
    assert len(flat) == len(leaves)
    for (path, want), p in zip(flat, leaves):
        assert p.grad is not None
        _leaf_scaled(p.grad, want, GRAD_TOL, jax.tree_util.keystr(path))


# ------------------------------------------------------------ serving

def test_prefill_and_decode_match_reference(smoke):
    cfg, ref_params, params = smoke
    batch = _prompt(cfg, 2, 16, seed=3)
    S = cfg.n_vision_tokens + batch["tokens"].shape[1]
    max_seq = S + DECODE     # the patches counted, as tests/test_models.py does
    toks = make_batch(cfg, 2, DECODE + 1, seed=9, step=0)["tokens"][:, :DECODE]
    lj, cj = ref_cache.prefill(cfg, ref_params, batch, max_seq=max_seq)
    lt, ct = port_cache.prefill(cfg, params, _torch(batch), max_seq=max_seq)
    for i in range(DECODE + 1):
        _close(lt, lj, LOGIT_TOL, f"logits after step {i}")
        assert int(ct["pos"]) == int(cj["pos"]) == S + i
        assert set(ct) == set(cj) == {"k", "v", "pos"}
        assert ct["k"].shape[2] == max_seq
        for key in ("k", "v"):
            _close(ct[key], cj[key], LOGIT_TOL, key)
        if i < DECODE:
            lj, cj = ref_cache.decode_step(cfg, ref_params, cj, toks[:, i:i + 1])
            lt, ct = port_cache.decode_step(cfg, params, ct, torch.from_numpy(toks[:, i:i + 1]))


def test_decode_matches_own_forward(smoke):
    cfg, _, params = smoke
    batch = _torch(_prompt(cfg, 1, 20, seed=2))      # 8 patches + 12 tokens
    full, _ = model.forward(cfg, params, batch)
    P, n = cfg.n_vision_tokens, batch["tokens"].shape[1]
    logits, cache = port_cache.prefill(cfg, params, {**batch, "tokens": batch["tokens"][:, :8]},
                                       max_seq=P + n)
    torch.testing.assert_close(logits[0, -1], full[0, P + 7], rtol=TF_PREFILL_TOL,
                               atol=TF_PREFILL_TOL)
    for t in range(8, n):
        logits, cache = port_cache.decode_step(cfg, params, cache, batch["tokens"][:, t:t + 1])
        torch.testing.assert_close(logits[0, -1], full[0, P + t], rtol=TF_DECODE_TOL,
                                   atol=TF_DECODE_TOL)


def _reference_loop(cfg, ref_params, batch, max_new):
    """The reference's prefill + greedy decode loop with a cache that holds
    every position: patches + S + max_new."""
    S = cfg.n_vision_tokens + batch["tokens"].shape[1]
    pre = jax.jit(ref_steps.make_prefill_step(cfg, max_seq=S + max_new))
    dec = jax.jit(ref_steps.make_decode_step(cfg))
    logits, cache = pre(ref_params, batch)
    tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)
    out = [tok]
    for _ in range(max_new - 1):
        tok, cache = dec(ref_params, cache, {"tokens": tok[:, None]})
        out.append(tok)
    return np.asarray(jnp.stack(out, axis=1))


@pytest.mark.parametrize("max_new", [4, 12])   # below and above the 8 patches
def test_generate_equals_the_reference_loop_at_the_right_cache_size(smoke, monkeypatch,
                                                                    max_new):
    cfg, ref_params, params = smoke
    batch = _prompt(cfg, 2, 16, seed=0)
    seen = []
    prefill = port_cache.prefill

    def spy(*a, **kw):
        seen.append(kw.get("max_seq"))
        return prefill(*a, **kw)

    monkeypatch.setattr(port_cache, "prefill", spy)
    got, stats = generate(cfg, params, batch, max_new=max_new, device="cpu")
    assert seen == [cfg.n_vision_tokens + batch["tokens"].shape[1] + max_new]
    assert got.dtype == torch.int32 and got.shape == (2, max_new)
    np.testing.assert_array_equal(got.numpy(), _reference_loop(cfg, ref_params, batch, max_new))
    if max_new < cfg.n_vision_tokens:   # the reference's generate: a cache short of the patches
        with pytest.raises(ValueError):
            ref_generate(cfg, ref_params, batch, max_new=max_new)


# ------------------------------------------------------------ training

def test_three_train_steps_match_reference(smoke):
    cfg, ref_params, port_params = smoke
    ref_step = jax.jit(ref_steps.make_train_step(cfg, warmup=1, base_lr=1e-3))
    port_step = steps.make_train_step(cfg, warmup=1, base_lr=1e-3)
    rs = {"params": ref_params, "opt": ref_get_optimizer(cfg.optimizer).init(ref_params),
          "step": jnp.zeros((), jnp.int32)}
    ps = {"params": port_params, "opt": get_optimizer(cfg.optimizer).init(port_params),
          "step": torch.zeros((), dtype=torch.int32)}
    for i in range(3):
        batch = make_batch(cfg, 2, 24, seed=2, step=i)
        rs, rm = ref_step(rs, batch)
        ps, pm = port_step(ps, batch)
        for k in ("loss", "ce", "gnorm", "lr"):
            np.testing.assert_allclose(float(pm[k]), float(rm[k]), rtol=STEP_TOL, err_msg=k)
    flat = jax.tree_util.tree_flatten_with_path(rs)[0]
    leaves = tree_leaves(ps)
    assert len(flat) == len(leaves)
    for (path, want), got in zip(flat, leaves):
        name = jax.tree_util.keystr(path)
        if name.startswith("['params']"):
            np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), rtol=0,
                                       atol=PARAM_ATOL, err_msg=name)
        elif name.startswith("['opt']") and np.ndim(want):
            _leaf_scaled(got, want, MOMENT_TOL, name)
        else:
            assert int(got) == int(want) == 3, name


# ------------------------------------------------------------ entry points

def test_serve_main_serves_the_vlm_smoke_config_on_the_cpu(capsys):
    serve_main(["--arch", ARCH, "--smoke", "--device", "cpu", "--tokens", "3",
                "--prompt-len", "20"])
    assert f"{ARCH}: generated (2, 3)" in capsys.readouterr().out


def test_train_main_trains_the_vlm_smoke_config_on_the_cpu(capsys):
    out = train_mod.main(["--arch", ARCH, "--smoke", "--steps", "2", "--batch", "2",
                          "--seq", "16", "--log-every", "1", "--device", "cpu"])
    assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))
    assert "done: 2 steps" in capsys.readouterr().out

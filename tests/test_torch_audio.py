"""The port's audio family (Whisper: an encoder over stub frame embeddings
plus sinusoidal positions, a decoder with self- and cross-attention, no
rotary) against the reference on the CPU, on ``get_smoke_config(
"whisper-medium")`` (2 encoder + 2 decoder layers, d_model 64, 4 heads of
16, layernorm, plain gelu MLP with biases, vocab 512, 24 frames), float32
compute: ``sinusoidal_positions``, the layouts, ``forward``, ``loss_fn`` and
every gradient leaf, ``prefill`` with its cross cache and 4
``decode_step``s, decode against the port's own teacher-forced ``forward``,
``generate``, three AdamW train steps and the entry points.  The
reference's parameters go through ``params_from_numpy``; frames and tokens
come from ``make_batch`` (numpy, from a seed).

Tolerances (float32):
- ``sinusoidal_positions`` against the reference's table: 1e-7 at the smoke
  size (24, 64) (6.0e-8 measured) and 3.1e-5 at Whisper's (1500, 1024)
  (3.05e-5 measured: angles up to 1500 rad turn an ulp of the power into
  ~1e-4 of sin / cos; the reference's jitted and eager tables agree bit for
  bit);
- the dense family's (tests/test_torch_dense.py): ``forward`` logits 2e-4
  (1.7e-6 measured), prefill / decode logits and caches 1e-4 (1.4e-6
  measured), decode against the port's own ``forward`` 2e-4 / 2e-3, loss
  rtol 1e-6, gradient leaves 2e-4 of their largest (6.5e-7 measured), train
  steps rtol 1e-5 / parameters atol 2e-5 / moments 2e-4 of their largest;
  greedy tokens and layouts identical.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.launch import steps as ref_steps
from repro.launch.serve import generate as ref_generate
from repro.models import cache as ref_cache
from repro.models import layers as ref_layers
from repro.models import model as ref_model
from repro.optim.optimizers import get_optimizer as ref_get_optimizer
from repro_torch.configs.registry import get_smoke_config
from repro_torch.data.pipeline import make_batch
from repro_torch.launch import steps
from repro_torch.launch import train as train_mod
from repro_torch.launch.serve import generate
from repro_torch.launch.serve import main as serve_main
from repro_torch.models import cache as port_cache
from repro_torch.models import layers
from repro_torch.models import model
from repro_torch.optim import get_optimizer
from repro_torch.tree import tree_leaves, tree_map

ARCH = "whisper-medium"
SINUSOID_TOL = {(24, 64): 1e-7, (1500, 1024): 3.1e-5}
FORWARD_TOL, LOGIT_TOL = 2e-4, 1e-4
TF_PREFILL_TOL, TF_DECODE_TOL = 2e-4, 2e-3
LOSS_TOL, GRAD_TOL = 1e-6, 2e-4
STEP_TOL, PARAM_ATOL, MOMENT_TOL = 1e-5, 2e-5, 2e-4
PROMPT, DECODE = 8, 4


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


def _prompt(cfg, B, S, seed):
    batch = make_batch(cfg, B, S, seed=seed, step=0)
    batch["tokens"] = batch["tokens"][:, :-1]
    return batch


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# ------------------------------------------------------------ positions, layout

@pytest.mark.parametrize("seq,d_model", list(SINUSOID_TOL))
def test_sinusoidal_positions_match_reference(seq, d_model):
    got = layers.sinusoidal_positions(seq, d_model, "cpu")
    jitted = jax.jit(ref_layers.sinusoidal_positions, static_argnums=(0, 1))(seq, d_model)
    assert got.shape == (seq, d_model) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(jitted), rtol=0,
                               atol=SINUSOID_TOL[(seq, d_model)])
    np.testing.assert_array_equal(np.asarray(jitted),
                                  np.asarray(ref_layers.sinusoidal_positions(seq, d_model)))


def test_layouts_match_reference(smoke):
    cfg, ref_params, _ = smoke
    got = model.init_params(0, cfg, device="cpu")
    assert _layout(got) == _layout(jax.tree.map(np.asarray, ref_params))
    assert got["enc_layers"]["attn"]["wq"].shape[0] == cfg.n_enc_layers
    assert set(got["layers"]) == {"attn", "xattn", "mlp"} and "bi" in got["layers"]["mlp"]
    cache = port_cache.init_cache(cfg, 2, 24, device="cpu")
    assert _layout(cache) == _layout(jax.tree.map(np.asarray, ref_cache.init_cache(cfg, 2, 24)))
    assert cache["xk"].shape[2] == cfg.enc_seq


# ------------------------------------------------------------ forward, loss

def test_forward_matches_reference(smoke):
    cfg, ref_params, params = smoke
    batch = _prompt(cfg, 2, 12, seed=3)
    want, want_aux = ref_model.forward(cfg, ref_params, batch)
    got, aux = model.forward(cfg, params, _torch(batch))
    assert got.shape == (2, 12, cfg.vocab_size)
    _close(got, want, FORWARD_TOL)
    assert float(aux) == float(want_aux) == 0.0
    enc = model.whisper_encode(cfg, model.cast_params(params, cfg), _torch(batch))
    want_enc = ref_model._whisper_forward(cfg, ref_params, batch, unroll=False, remat=False,
                                          frames_out_only=True)
    _close(enc, want_enc, FORWARD_TOL, "encoder output")


def test_loss_and_every_gradient_match_reference(smoke):
    cfg, ref_params, port_params = smoke
    batch = make_batch(cfg, 2, 16, seed=1, step=0)
    (want_loss, want_parts), want_grads = jax.jit(jax.value_and_grad(
        lambda p: ref_model.loss_fn(cfg, p, batch), has_aux=True))(ref_params)
    params = tree_map(lambda p: p.clone().requires_grad_(), port_params)
    loss, parts = model.loss_fn(cfg, params, batch)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=LOSS_TOL)
    np.testing.assert_allclose(float(parts["ce"].detach()), float(want_parts["ce"]),
                               rtol=LOSS_TOL)
    flat = jax.tree_util.tree_flatten_with_path(want_grads)[0]
    leaves = tree_leaves(params)
    assert len(flat) == len(leaves)
    for (path, want), p in zip(flat, leaves):
        assert p.grad is not None
        _leaf_scaled(p.grad, want, GRAD_TOL, jax.tree_util.keystr(path))


# ------------------------------------------------------------ serving

def test_prefill_with_its_cross_cache_and_decode_match_reference(smoke):
    cfg, ref_params, params = smoke
    full = _prompt(cfg, 2, PROMPT + DECODE, seed=3)
    toks = full["tokens"]
    S = toks.shape[1]
    pre = {**full, "tokens": toks[:, :PROMPT]}
    lj, cj = ref_cache.prefill(cfg, ref_params, pre, max_seq=S)
    lt, ct = port_cache.prefill(cfg, params, _torch(pre), max_seq=S)
    for i, t in enumerate(range(PROMPT, S + 1)):
        _close(lt, lj, LOGIT_TOL, f"logits after step {i}")
        assert int(ct["pos"]) == int(cj["pos"]) == PROMPT + i
        assert set(ct) == set(cj) == {"k", "v", "xk", "xv", "pos"}
        assert ct["xk"].shape == (cfg.n_layers, 2, cfg.enc_seq, cfg.n_kv_heads, cfg.dh)
        for key in ("k", "v", "xk", "xv"):
            _close(ct[key], cj[key], LOGIT_TOL, key)
        if t < S:
            before = {k: v.clone() for k, v in ct.items()}
            lj, cj = ref_cache.decode_step(cfg, ref_params, cj, toks[:, t:t + 1])
            lt, new = port_cache.decode_step(cfg, params, ct, torch.from_numpy(toks[:, t:t + 1]))
            assert all(torch.equal(ct[k], before[k]) for k in ct)   # the caller's cache
            assert new["xk"] is ct["xk"]                              # shared, never written
            ct = new


def test_decode_matches_own_forward(smoke):
    cfg, _, params = smoke
    batch = _torch(_prompt(cfg, 1, 12, seed=2))
    full, _ = model.forward(cfg, params, batch)
    logits, cache = port_cache.prefill(cfg, params, {**batch, "tokens": batch["tokens"][:, :8]},
                                       max_seq=12)
    torch.testing.assert_close(logits[0, -1], full[0, 7], rtol=TF_PREFILL_TOL,
                               atol=TF_PREFILL_TOL)
    for t in range(8, 12):
        logits, cache = port_cache.decode_step(cfg, params, cache, batch["tokens"][:, t:t + 1])
        torch.testing.assert_close(logits[0, -1], full[0, t], rtol=TF_DECODE_TOL,
                                   atol=TF_DECODE_TOL)


def test_generate_gives_the_reference_tokens(smoke, monkeypatch):
    cfg, ref_params, params = smoke
    batch = _prompt(cfg, 2, 12, seed=0)
    seen = []
    prefill = port_cache.prefill

    def spy(*a, **kw):
        seen.append(kw.get("max_seq"))
        return prefill(*a, **kw)

    monkeypatch.setattr(port_cache, "prefill", spy)
    want, _ = ref_generate(cfg, ref_params, batch, max_new=8)
    got, stats = generate(cfg, params, batch, max_new=8, device="cpu")
    assert seen == [12 + 8]
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert stats["tok_per_s"] > 0


# ------------------------------------------------------------ training

def test_three_adamw_steps_match_reference(smoke):
    cfg, ref_params, port_params = smoke
    assert cfg.optimizer == "adamw"
    ref_step = jax.jit(ref_steps.make_train_step(cfg, warmup=1, base_lr=1e-3))
    port_step = steps.make_train_step(cfg, warmup=1, base_lr=1e-3)
    rs = {"params": ref_params, "opt": ref_get_optimizer(cfg.optimizer).init(ref_params),
          "step": jnp.zeros((), jnp.int32)}
    ps = {"params": port_params, "opt": get_optimizer(cfg.optimizer).init(port_params),
          "step": torch.zeros((), dtype=torch.int32)}
    for i in range(3):
        batch = make_batch(cfg, 2, 16, seed=2, step=i)
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

def test_serve_main_serves_the_audio_smoke_config_on_the_cpu(capsys):
    serve_main(["--arch", ARCH, "--smoke", "--device", "cpu", "--tokens", "3",
                "--prompt-len", "9"])
    assert f"{ARCH}: generated (2, 3)" in capsys.readouterr().out


def test_train_main_trains_the_audio_smoke_config_on_the_cpu(capsys):
    out = train_mod.main(["--arch", ARCH, "--smoke", "--steps", "2", "--batch", "2",
                          "--seq", "8", "--log-every", "1", "--device", "cpu"])
    assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))
    assert "done: 2 steps" in capsys.readouterr().out

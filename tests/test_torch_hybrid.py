"""The port's hybrid family (Mamba, the chunked scan, Jamba's blocks)
against the reference on the CPU, on ``get_smoke_config(
"jamba-1.5-large-398b")`` (one period-8 block: 7 Mamba + 1 attention
sublayer, 4 dense + 4 MoE FFNs; d_model 64, d_inner 128, d_state 16, dt
rank 8, conv 4, 8 experts top 2, vocab 512), float32 compute: the causal
conv, the selective scan with and without a start state, the Mamba block's
forward and decode carry, ``chunked_scan`` chunked (S = 256) and plain (S =
100), the parameter and cache layouts, ``forward`` (also at S = 256, where
the scan chunks) with every routing decision, ``loss_fn`` and every
gradient leaf, ``prefill`` with 4 ``decode_step``s, decode against the
port's own teacher-forced ``forward``, ``generate``, three Adafactor train
steps and ``launch.serve`` / ``launch.train``.  The reference's parameters
(``jax.random``) go through ``params_from_numpy``; inputs come from a seed
with numpy.

Tolerances (float32), the dense family's (tests/test_torch_dense.py):
- the conv: identical; one scan, one Mamba block and its carry: rtol = atol
  = 1e-5 (SCAN_TOL; 1.2e-7 measured on a block's output);
- ``chunked_scan`` against the plain loop: identical carry, outputs and
  gradients (the same operations in the same order), and it keeps under a
  tenth of the plain loop's saved tensors;
- ``forward`` logits: 2e-4 (FORWARD_TOL; 9.5e-6 measured at S = 24, 1.4e-5
  at S = 256); prefill and decode logits and caches: 1e-4 (LOGIT_TOL;
  7.5e-6 measured); decode against the port's own ``forward``: 2e-4 / 2e-3;
- loss rtol 1e-6 (7e-8 measured), each gradient leaf within 2e-4 of its
  largest |reference gradient| (5.6e-6 measured); three train steps: loss,
  gnorm, lr rtol 1e-5, parameters atol 2e-5, the factored moments within
  2e-4 of the leaf's largest;
- greedy tokens, routing (expert ids, positions, kept masks) and layouts:
  identical.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs.registry import get_smoke_config as ref_smoke
from repro.launch import steps as ref_steps
from repro.launch.serve import generate as ref_generate
from repro.models import cache as ref_cache
from repro.models import mamba as ref_mamba
from repro.models import model as ref_model
from repro.models import moe as ref_moe
from repro.models import scan_utils as ref_scan
from repro.optim.optimizers import get_optimizer as ref_get_optimizer
from repro_torch.configs.registry import get_smoke_config
from repro_torch.data.pipeline import make_batch
from repro_torch.launch import steps
from repro_torch.launch import train as train_mod
from repro_torch.launch.serve import generate
from repro_torch.launch.serve import main as serve_main
from repro_torch.models import cache as port_cache
from repro_torch.models import mamba
from repro_torch.models import model
from repro_torch.models import moe as port_moe
from repro_torch.models.scan_utils import chunked_scan
from repro_torch.optim import get_optimizer
from repro_torch.tree import tree_leaves, tree_map

ARCH = "jamba-1.5-large-398b"
SCAN_TOL = 1e-5
FORWARD_TOL, LOGIT_TOL = 2e-4, 1e-4
TF_PREFILL_TOL, TF_DECODE_TOL = 2e-4, 2e-3
LOSS_TOL, GRAD_TOL = 1e-6, 2e-4
STEP_TOL, PARAM_ATOL, MOMENT_TOL = 1e-5, 2e-5, 2e-4
PROMPT, DECODE = 8, 4
CHUNKED = 256   # > 128 and a multiple of it: chunked_scan takes its chunked path


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


def _tokens(cfg, B, S, seed):
    return make_batch(cfg, B, S, seed=seed, step=0)["tokens"][:, :-1]


def _sublayer(tree, i):
    return tree_map(lambda a: a[0, i], tree)


def _mamba_p(smoke, i=0):
    cfg, ref_params, params = smoke
    return (jax.tree.map(lambda a: a[0, i], ref_params["blocks"]["mamba"]),
            _sublayer(params["blocks"]["mamba"], i))


# ------------------------------------------------------------ Mamba pieces

def test_conv_causal_matches_reference(smoke):
    cfg = smoke[0]
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (2, 10, cfg.d_inner)).astype(np.float32)
    w = rng.normal(0, 0.5, (cfg.ssm_conv, cfg.d_inner)).astype(np.float32)
    b = rng.normal(0, 0.1, cfg.d_inner).astype(np.float32)
    got = mamba._conv_causal(*map(torch.from_numpy, (x, w, b)))
    want = ref_mamba._conv_causal(*map(jnp.asarray, (x, w, b)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # causal: the first output sees only the first input
    x2 = x.copy()
    x2[:, 1:] = 0
    np.testing.assert_array_equal(mamba._conv_causal(*map(torch.from_numpy, (x2, w, b)))
                                  [:, 0].numpy(), got[:, 0].numpy())


def _scan_inputs(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    DI, N = cfg.d_inner, cfg.ssm_d_state
    u = rng.normal(0, 1, (B, S, DI)).astype(np.float32)
    dt = rng.uniform(0.001, 0.1, (B, S, DI)).astype(np.float32)
    Bm, Cm = (rng.normal(0, 1, (B, S, N)).astype(np.float32) for _ in range(2))
    A = -np.tile(np.arange(1, N + 1, dtype=np.float32), (DI, 1))
    h0 = rng.normal(0, 1, (B, DI, N)).astype(np.float32)
    return u, dt, Bm, Cm, A, h0


@pytest.mark.parametrize("with_state", [False, True])
def test_ssm_scan_matches_reference(smoke, with_state):
    *args, h0 = _scan_inputs(smoke[0], 2, 12, seed=1)
    init = h0 if with_state else None
    y, h = mamba._ssm_scan(*map(torch.from_numpy, args),
                           None if init is None else torch.from_numpy(init))
    yj, hj = ref_mamba._ssm_scan(*map(jnp.asarray, args),
                                 None if init is None else jnp.asarray(init))
    assert y.dtype == h.dtype == torch.float32 and h.shape == (2, 128, 16)
    _close(y, yj, SCAN_TOL, "y")
    _close(h, hj, SCAN_TOL, "state")


def test_mamba_block_train_path_and_decode_carry_match_reference(smoke):
    cfg = smoke[0]
    ref_p, p = _mamba_p(smoke, 2)
    x = np.random.default_rng(2).normal(0, 1, (2, 9, cfg.d_model)).astype(np.float32)
    out, st = mamba.mamba_block(cfg, p, torch.from_numpy(x))
    out_j, st_j = ref_mamba.mamba_block(cfg, ref_p, jnp.asarray(x))
    _close(out, out_j, SCAN_TOL, "train path")
    _close(st["conv"], st_j["conv"], SCAN_TOL, "conv window")
    _close(st["ssm"], st_j["ssm"], SCAN_TOL, "ssm state")
    # the carry: the first 6 tokens from a zero state, then one at a time
    state = mamba.mamba_init_state(cfg, 2, device="cpu")
    state_j = ref_mamba.mamba_init_state(cfg, 2)
    assert _layout(state) == _layout(jax.tree.map(np.asarray, state_j))
    outs = []
    for lo, hi in ((0, 6), (6, 7), (7, 8), (8, 9)):
        o, state = mamba.mamba_block(cfg, p, torch.from_numpy(x[:, lo:hi]), state)
        o_j, state_j = ref_mamba.mamba_block(cfg, ref_p, jnp.asarray(x[:, lo:hi]), state_j)
        _close(o, o_j, SCAN_TOL, f"carry {lo}:{hi}")
        _close(state["ssm"], state_j["ssm"], SCAN_TOL)
        _close(state["conv"], state_j["conv"], SCAN_TOL)
        outs.append(o)
    # the carry continues the train path
    _close(torch.cat(outs, dim=1), _np(out), SCAN_TOL, "carry against the train path")


def test_mamba_params_have_the_reference_layout_and_fp32_leaves(smoke):
    cfg = smoke[0]
    gen = torch.Generator().manual_seed(0)
    got = mamba.mamba_params(gen, cfg, torch.bfloat16, lead=(2, 3))
    want = ref_mamba.mamba_params(jax.random.PRNGKey(0), cfg, jnp.bfloat16)
    want = jax.tree.map(lambda a: np.zeros((2, 3) + a.shape, a.dtype), want)
    assert _layout(got) == _layout(want)
    assert got["alog"].dtype == got["dskip"].dtype == torch.float32
    np.testing.assert_array_equal(got["alog"][1, 2].numpy(),
                                  np.log(np.tile(np.arange(1, 17, dtype=np.float32), (128, 1))))


# ------------------------------------------------------------ chunked scan

def _scan_step(h, inp):
    a, b = inp
    h = h * torch.sigmoid(a) + torch.tanh(b)
    return h, (h * h).sum(-1)


@pytest.mark.parametrize("S,chunked", [(CHUNKED, True), (100, False)])
def test_chunked_scan_equals_the_plain_loop_with_gradients(S, chunked):
    rng = np.random.default_rng(S)
    a0, b0 = (torch.from_numpy(rng.normal(0, 1, (S, 3, 5)).astype(np.float32))
              for _ in range(2))
    h0 = torch.from_numpy(rng.normal(0, 1, (3, 5)).astype(np.float32))
    runs, saved = [], []
    for chunk in (128, S):   # chunk = S: the plain loop
        a, b, h = (t.clone().requires_grad_() for t in (a0, b0, h0))
        n = [0]
        with torch.autograd.graph.saved_tensors_hooks(
                lambda t: n.__setitem__(0, n[0] + 1) or t, lambda t: t):
            carry, ys = chunked_scan(_scan_step, h, (a, b), chunk=chunk)
        assert ys.shape == (S, 3)
        (carry.sum() + (ys * torch.arange(S)[:, None]).sum()).backward()
        runs.append((carry, ys, a.grad, b.grad, h.grad))
        saved.append(n[0])
    for got, want in zip(*runs):
        assert torch.equal(got, want)
    # chunked: only the chunk boundaries are kept; plain: every step's residuals
    assert (saved[0] < saved[1] / 10) == chunked, saved
    # the reference's scan, on the same step in jnp
    def step_j(h, inp):
        h = h * jax.nn.sigmoid(inp[0]) + jnp.tanh(inp[1])
        return h, (h * h).sum(-1)
    cj, yj = ref_scan.chunked_scan(step_j, jnp.asarray(h0.numpy()),
                                   (jnp.asarray(a0.numpy()), jnp.asarray(b0.numpy())))
    _close(runs[0][0], cj, SCAN_TOL)
    _close(runs[0][1], yj, SCAN_TOL)


def test_ssm_scan_chunks_at_256_and_matches_reference(smoke):
    *args, h0 = _scan_inputs(smoke[0], 1, CHUNKED, seed=4)
    y, h = mamba._ssm_scan(*map(torch.from_numpy, args), torch.from_numpy(h0))
    yj, hj = ref_mamba._ssm_scan(*map(jnp.asarray, args), jnp.asarray(h0))
    _close(y, yj, SCAN_TOL, "y")
    _close(h, hj, SCAN_TOL, "state")


# ------------------------------------------------------------ layouts

def test_init_params_has_the_reference_layout(smoke):
    cfg, ref_params, _ = smoke
    got = model.init_params(0, cfg, device="cpu")
    assert _layout(got) == _layout(jax.tree.map(np.asarray, ref_params))
    assert got["blocks"]["mamba"]["win"].shape[:2] == (1, 7)
    assert got["blocks"]["ffn_moe"]["wei"].shape[:3] == (1, 4, 8)
    bf = model.init_params(0, cfg.replace(param_dtype="bfloat16"), device="cpu")
    want = ref_model.init_params(jax.random.PRNGKey(0), cfg.replace(param_dtype="bfloat16"))
    assert _layout(bf) == _layout(jax.tree.map(np.asarray, want))
    assert bf["blocks"]["mamba"]["alog"].dtype == bf["blocks"]["ffn_moe"]["wr"].dtype \
        == torch.float32


def test_init_cache_has_the_reference_layout(smoke):
    cfg = smoke[0]
    got = port_cache.init_cache(cfg, 2, 24, device="cpu")
    want = ref_cache.init_cache(cfg, 2, 24)
    assert _layout(got) == _layout(jax.tree.map(np.asarray, want))
    assert all(not bool(v.any()) for v in got.values())
    with pytest.raises(ValueError, match="max_seq"):
        port_cache.init_cache(cfg, 2, device="cpu")


# ------------------------------------------------------------ serving

class Routes:
    """Each ``_route`` call's expert ids and positions, and its capacity; the
    reference's come out of its traced program through an ordered
    ``jax.debug.callback``."""

    def __init__(self, module):
        self.module, self.plain, self.calls = module, module._route, []

    def __call__(self, cfg, xt, wr):
        out = self.plain(cfg, xt, wr)
        cap = self.module.expert_capacity(cfg, xt.shape[0])
        if torch.is_tensor(out[0]):
            self.calls.append((out[0].numpy(), out[1].numpy(), cap))
        else:
            jax.debug.callback(lambda e, p: self.calls.append(
                (np.asarray(e), np.asarray(p), cap)), out[0], out[1], ordered=True)
        return out


def _same_routes(got, want):
    assert len(got.calls) == len(want.calls) > 0
    for (e, p, c), (ej, pj, cj) in zip(got.calls, want.calls):
        assert c == cj
        np.testing.assert_array_equal(e, ej)
        np.testing.assert_array_equal(p, pj)
        np.testing.assert_array_equal(p < c, pj < cj)


@pytest.mark.parametrize("S", [24, CHUNKED])
def test_forward_and_routing_match_reference(smoke, monkeypatch, S):
    cfg, ref_params, params = smoke
    toks = _tokens(cfg, 2 if S == 24 else 1, S, seed=3)
    got_r, want_r = Routes(port_moe), Routes(ref_moe)
    monkeypatch.setattr(port_moe, "_route", got_r)
    monkeypatch.setattr(ref_moe, "_route", want_r)
    want, want_aux = ref_model.forward(cfg, ref_params, {"tokens": toks}, remat=False)
    jax.effects_barrier()
    got, aux = model.forward(cfg, params, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (toks.shape[0], S, cfg.vocab_size)
    _close(got, want, FORWARD_TOL)
    _close(aux, want_aux, LOSS_TOL)
    assert float(aux) > 0
    _same_routes(got_r, want_r)
    assert len(got_r.calls) == 4


def test_prefill_and_decode_match_reference(smoke):
    cfg, ref_params, params = smoke
    toks = _tokens(cfg, 2, PROMPT + DECODE, seed=3)
    S = toks.shape[1]
    lj, cj = ref_cache.prefill(cfg, ref_params, {"tokens": toks[:, :PROMPT]}, max_seq=S)
    lt, ct = port_cache.prefill(cfg, params, {"tokens": torch.from_numpy(toks[:, :PROMPT])},
                                max_seq=S)
    for i, t in enumerate(range(PROMPT, S + 1)):
        assert lt.shape == (2, 1, cfg.vocab_size)
        _close(lt, lj, LOGIT_TOL, f"logits after step {i}")
        assert int(ct["pos"]) == int(cj["pos"]) == PROMPT + i
        assert set(ct) == set(cj) == {"k", "v", "conv", "ssm", "pos"}
        for key in ct:
            _close(ct[key], cj[key], LOGIT_TOL, key)
        if t < S:
            before = {k: v.clone() for k, v in ct.items()}
            lj, cj = ref_cache.decode_step(cfg, ref_params, cj, toks[:, t:t + 1])
            lt, new = port_cache.decode_step(cfg, params, ct, torch.from_numpy(toks[:, t:t + 1]))
            assert all(torch.equal(ct[k], before[k]) for k in ct)   # the caller's cache
            ct = new


def test_decode_matches_own_forward_through_the_chunked_scan(smoke):
    """Prefill CHUNKED tokens (the scan's chunked path), decode 4, against
    teacher-forced ``forward``.  Capacity depends on how many tokens a call
    routes, so this runs at a capacity factor that keeps every assignment
    (C = T): nothing drops in forward, prefill or decode."""
    cfg, _, params = smoke
    cfg = cfg.replace(capacity_factor=cfg.n_experts / cfg.experts_per_token)
    toks = torch.from_numpy(_tokens(cfg, 1, CHUNKED + DECODE, seed=2))
    full, _ = model.forward(cfg, params, {"tokens": toks})
    logits, cache = port_cache.prefill(cfg, params, {"tokens": toks[:, :CHUNKED]},
                                       max_seq=CHUNKED + DECODE)
    torch.testing.assert_close(logits[0, -1], full[0, CHUNKED - 1], rtol=TF_PREFILL_TOL,
                               atol=TF_PREFILL_TOL)
    for t in range(CHUNKED, CHUNKED + DECODE):
        logits, cache = port_cache.decode_step(cfg, params, cache, toks[:, t:t + 1])
        torch.testing.assert_close(logits[0, -1], full[0, t], rtol=TF_DECODE_TOL,
                                   atol=TF_DECODE_TOL)


def test_generate_gives_the_reference_tokens(smoke):
    cfg, ref_params, params = smoke
    batch = make_batch(cfg, 2, 12, seed=0, step=0)
    batch["tokens"] = batch["tokens"][:, :-1]
    want, _ = ref_generate(cfg, ref_params, batch, max_new=8)
    got, stats = generate(cfg, params, batch, max_new=8, device="cpu")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert stats["tok_per_s"] > 0


# ------------------------------------------------------------ training

def test_loss_and_every_gradient_match_reference(smoke):
    cfg, ref_params, port_params = smoke
    batch = make_batch(cfg, 2, 24, seed=1, step=0)
    (want_loss, want_parts), want_grads = jax.jit(jax.value_and_grad(
        lambda p: ref_model.loss_fn(cfg, p, batch), has_aux=True))(ref_params)
    params = tree_map(lambda p: p.clone().requires_grad_(), port_params)
    loss, parts = model.loss_fn(cfg, params, batch)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=LOSS_TOL)
    for k in ("ce", "aux"):
        np.testing.assert_allclose(float(parts[k].detach()), float(want_parts[k]),
                                   rtol=LOSS_TOL, err_msg=k)
    flat = jax.tree_util.tree_flatten_with_path(want_grads)[0]
    leaves = tree_leaves(params)
    assert len(flat) == len(leaves)
    for (path, want), p in zip(flat, leaves):
        assert p.grad is not None and p.grad.dtype == p.dtype
        _leaf_scaled(p.grad, want, GRAD_TOL, jax.tree_util.keystr(path))


def test_remat_changes_no_gradient_through_the_chunked_scan(smoke):
    """Per-block checkpoints with the scan's per-chunk checkpoints nested
    inside give the gradients of the run that keeps everything."""
    cfg, _, port_params = smoke
    batch = make_batch(cfg, 1, CHUNKED, seed=3, step=0)
    grads = {}
    for remat in ("full", "none"):
        params = tree_map(lambda p: p.clone().requires_grad_(), port_params)
        model.loss_fn(cfg.replace(remat=remat), params, batch)[0].backward()
        grads[remat] = [p.grad for p in tree_leaves(params)]
    assert all(torch.equal(a, b) for a, b in zip(grads["full"], grads["none"]))


def test_three_adafactor_steps_match_reference(smoke):
    cfg, ref_params, port_params = smoke
    assert cfg.optimizer == "adafactor"
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
        elif name.startswith("['opt']['f']"):
            _leaf_scaled(got, want, MOMENT_TOL, name)
        else:
            assert int(got) == int(want) == 3, name


# ------------------------------------------------------------ entry points

def test_serve_main_serves_the_hybrid_smoke_config_on_the_cpu(capsys):
    serve_main(["--arch", ARCH, "--smoke", "--device", "cpu", "--tokens", "3",
                "--prompt-len", "9"])
    assert f"{ARCH}: generated (2, 3)" in capsys.readouterr().out


def test_train_main_trains_the_hybrid_smoke_config_on_the_cpu(capsys):
    out = train_mod.main(["--arch", ARCH, "--smoke", "--steps", "2", "--batch", "2",
                          "--seq", "8", "--log-every", "1", "--device", "cpu"])
    assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))
    assert "done: 2 steps" in capsys.readouterr().out

"""The port's RWKV-6 training path against the reference on the CPU, on
``get_smoke_config("rwkv6-1.6b")`` (2 layers, d_model 64, 4 heads of 16,
vocab 512, float32 compute): ``cross_entropy``, ``loss_fn`` and the autograd
gradient of every parameter leaf against ``jax.grad``, per-layer remat, three
``make_train_step`` steps against the reference's jitted step, the synthetic
token stream and its prefetcher, the canary straggler monitor, the
``launch.train.main`` and checkpoint/resume, restorable across the two
packages.  The reference's parameters (``jax.random``) go through
``params_from_numpy``, so both packages start from the same weights.

Tolerances (float32; the reference sums in other orders, and XLA fuses):
- ``cross_entropy``: rtol 1e-6;
- the loss: rtol 1e-6; each gradient leaf within 2e-4 of the leaf's largest
  |reference gradient| (4.4e-5 measured, on ``layers.ln_t``);
- three train steps (AdamW, warm-up 1, lr 1e-3): loss, gnorm and lr within
  rtol 1e-5 (5e-6 measured on gnorm); parameters within atol 2e-5 (1.5e-6
  measured; an update moves a parameter by up to 1e-3), moments within 2e-4
  of the leaf's largest |reference moment| (2e-5 measured);
- ``main``'s logged losses within rtol 1e-5; tokens, verdicts and
  checkpoint leaves identical.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.checkpoint import CheckpointManager as RefCheckpointManager
from repro.data.pipeline import Prefetcher as RefPrefetcher
from repro.data.pipeline import SyntheticLM as RefSyntheticLM
from repro.launch import steps as ref_steps
from repro.launch.train import main as ref_main
from repro.models import layers as ref_layers
from repro.models import model as ref_model
from repro.optim.optimizers import get_optimizer as ref_get_optimizer
from repro.runtime import straggler as ref_straggler
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.registry import get_smoke_config
from repro_torch.data import Prefetcher, SyntheticLM, make_batch
from repro_torch.kernels import wkv6 as wkv6_mod
from repro_torch.launch import steps
from repro_torch.launch import train as train_mod
from repro_torch.models import layers
from repro_torch.models import model
from repro_torch.optim import get_optimizer
from repro_torch.runtime import straggler
from repro_torch.tree import tree_leaves, tree_map

ARCH = "rwkv6-1.6b"
LOSS_TOL, GRAD_TOL = 1e-6, 2e-4
STEP_TOL, PARAM_ATOL, MOMENT_TOL = 1e-5, 2e-5, 2e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These tensors are small: one intra-op thread runs them as fast and
    leaves the host's cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def smoke():
    cfg = get_smoke_config(ARCH)
    params = ref_model.init_params(jax.random.PRNGKey(3), cfg)
    return cfg, params, model.params_from_numpy(jax.tree.map(np.asarray, params), "cpu")


def _np(t):
    return t.detach().float().numpy()


def _assert_leaf_scaled(got, want, tol, what):
    """|got - want| <= tol * max |want| over the leaf."""
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=tol * max(float(np.abs(want).max()), 1e-30),
                               err_msg=what)


def _paths(tree):
    return [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _state(params, opt):
    return {"params": params, "opt": opt.init(params),
            "step": torch.zeros((), dtype=torch.int32)}


# ---------------------------------------------------------------- loss

@pytest.mark.parametrize("with_mask", [False, True])
def test_cross_entropy_matches_reference(with_mask):
    rng = np.random.default_rng(1)
    logits = rng.normal(0, 3, (2, 5, 17)).astype(np.float32)
    labels = rng.integers(0, 17, (2, 5)).astype(np.int32)
    mask = (rng.random((2, 5)) < 0.6).astype(np.float32) if with_mask else None
    want = ref_layers.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                    None if mask is None else jnp.asarray(mask))
    got = layers.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                               None if mask is None else torch.from_numpy(mask))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_TOL)
    empty = layers.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                                 torch.zeros((2, 5)))
    assert float(empty) == 0.0   # an all-zero mask divides by 1, as the reference


def test_loss_and_every_gradient_match_reference(smoke):
    cfg, ref_params, port_params = smoke
    batch = make_batch(cfg, 2, 24, seed=1, step=0)
    (want_loss, want_parts), want_grads = jax.jit(jax.value_and_grad(
        lambda p: ref_model.loss_fn(cfg, p, batch), has_aux=True))(ref_params)
    params = tree_map(lambda p: p.clone().requires_grad_(), port_params)
    loss, parts = model.loss_fn(cfg, params, batch)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=LOSS_TOL)
    np.testing.assert_allclose(float(parts["ce"]), float(want_parts["ce"]), rtol=LOSS_TOL)
    assert float(parts["aux"]) == float(want_parts["aux"]) == 0.0
    flat = jax.tree_util.tree_flatten_with_path(want_grads)[0]
    leaves = tree_leaves(params)
    assert len(flat) == len(leaves)
    for (path, want), p in zip(flat, leaves):
        assert p.grad is not None and p.grad.dtype == p.dtype
        _assert_leaf_scaled(p.grad, want, GRAD_TOL, jax.tree_util.keystr(path))


def test_bfloat16_gradients_reach_decay_bonus_and_kv(smoke, monkeypatch):
    """In the config's bfloat16 compute the recurrence gets bfloat16 k and v
    and returns their gradients in bfloat16, r, wlog and u's in float32; the
    float32 master parameters u, w0, wa, wb (the decay LoRA) get finite,
    nonzero gradients."""
    cfg, _, port_params = smoke
    bf = cfg.replace(compute_dtype="bfloat16")
    seen = []
    plain = wkv6_mod.wkv6_bwd_ref

    def spy(*args, **kw):
        out = plain(*args, **kw)
        seen.append(([a.dtype for a in args[:5]], [g.dtype for g in out[:5]]))
        return out

    monkeypatch.setattr(wkv6_mod, "wkv6_bwd_ref", spy)
    params = tree_map(lambda p: p.clone().requires_grad_(), port_params)
    loss, _ = model.loss_fn(bf, params, make_batch(bf, 2, 12, seed=2, step=0))
    loss.backward()
    f32, b16 = torch.float32, torch.bfloat16
    assert seen == [([f32, b16, b16, f32, f32], [f32, b16, b16, f32, f32])] * bf.n_layers
    for name in ("u", "w0", "wa", "wb"):
        g = params["layers"][name].grad
        assert g.dtype == torch.float32 and bool(torch.isfinite(g).all()) and bool(g.any())


def test_remat_recomputes_each_layer_and_changes_no_gradient(smoke, monkeypatch):
    cfg, _, port_params = smoke
    calls = {"fwd": 0, "bwd": 0}

    def count(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(wkv6_mod, "wkv6_ref", count("fwd", wkv6_mod.wkv6_ref))
    monkeypatch.setattr(wkv6_mod, "wkv6_bwd_ref", count("bwd", wkv6_mod.wkv6_bwd_ref))
    batch = make_batch(cfg, 2, 10, seed=3, step=0)
    grads = {}
    for remat in ("full", "none"):
        calls.update(fwd=0, bwd=0)
        params = tree_map(lambda p: p.clone().requires_grad_(), port_params)
        model.loss_fn(cfg.replace(remat=remat), params, batch)[0].backward()
        L = cfg.n_layers
        assert calls == {"fwd": 2 * L if remat == "full" else L, "bwd": L}
        grads[remat] = [p.grad for p in tree_leaves(params)]
    assert all(torch.equal(a, b) for a, b in zip(grads["full"], grads["none"]))
    with torch.no_grad():   # no autograd: no recompute
        calls.update(fwd=0)
        model.forward(cfg, port_params, {"tokens": batch["tokens"][:, :-1]})
        assert calls["fwd"] == cfg.n_layers


# ---------------------------------------------------------------- train step

def test_three_train_steps_match_reference(smoke):
    cfg, ref_params, port_params = smoke
    ref_step = jax.jit(ref_steps.make_train_step(cfg, warmup=1, base_lr=1e-3))
    port_step = steps.make_train_step(cfg, warmup=1, base_lr=1e-3)
    ref_opt = ref_get_optimizer(cfg.optimizer)
    rs = {"params": ref_params, "opt": ref_opt.init(ref_params),
          "step": jnp.zeros((), jnp.int32)}
    ps = _state(port_params, get_optimizer(cfg.optimizer))
    for i in range(3):
        batch = make_batch(cfg, 2, 16, seed=2, step=i)
        rs, rm = ref_step(rs, batch)
        ps, pm = port_step(ps, batch)
        assert set(pm) == set(rm) == {"loss", "ce", "aux", "gnorm", "lr"}
        for k in ("loss", "ce", "gnorm", "lr"):
            np.testing.assert_allclose(float(pm[k]), float(rm[k]), rtol=STEP_TOL, err_msg=k)
    flat = jax.tree_util.tree_flatten_with_path(rs)[0]
    leaves = tree_leaves(ps)
    assert [jax.tree_util.keystr(p) for p, _ in flat] == _paths(
        jax.tree.map(lambda _: 0, rs)) and len(flat) == len(leaves)
    for (path, want), got in zip(flat, leaves):
        name = jax.tree_util.keystr(path)
        assert tuple(got.shape) == np.shape(want) and str(got.dtype)[6:] == str(want.dtype)
        if name.startswith("['params']"):
            np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=PARAM_ATOL,
                                       err_msg=name)
        elif name.startswith("['opt']['m']") or name.startswith("['opt']['v']"):
            _assert_leaf_scaled(got, want, MOMENT_TOL, name)
        else:
            assert int(got) == int(want) == 3, name


def test_first_step_moves_the_moments_not_the_parameters(smoke):
    """The schedule's rate at step 0 is 0, as the reference's."""
    cfg, _, port_params = smoke
    state = _state(port_params, get_optimizer(cfg.optimizer))
    new, metrics = steps.make_train_step(cfg)(state, make_batch(cfg, 2, 8, seed=0, step=0))
    assert float(metrics["lr"]) == 0.0 and int(new["step"]) == 1
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(new["params"]),
                                                 tree_leaves(port_params)))
    assert bool(new["opt"]["m"]["layers"]["wk"].any())
    assert all(not p.requires_grad for p in tree_leaves(new))


# ---------------------------------------------------------------- data, runtime

@pytest.mark.parametrize("shard,n_shards", [(0, 1), (1, 2)])
def test_synthetic_stream_and_prefetcher_match_reference(shard, n_shards):
    cfg = get_smoke_config(ARCH)
    kw = dict(seed=4, shard=shard, n_shards=n_shards)
    ref_it = iter(RefSyntheticLM(cfg, 6, 20, **kw))
    want = [next(ref_it)["tokens"] for _ in range(5)]
    got = [b["tokens"] for _, b in zip(range(5), SyntheticLM(cfg, 6, 20, **kw))]
    fetched = [b["tokens"] for _, b in zip(range(5), Prefetcher(SyntheticLM(cfg, 6, 20, **kw)))]
    ref_fetched = [b["tokens"] for _, b in
                   zip(range(5), RefPrefetcher(RefSyntheticLM(cfg, 6, 20, **kw)))]
    for a, b, c, d in zip(got, want, fetched, ref_fetched):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(c, b)
        np.testing.assert_array_equal(d, b)


def test_prefetcher_ends_with_its_source():
    assert [x for x in Prefetcher(range(5), depth=2)] == list(range(5))


@pytest.mark.parametrize("kw,probe", [
    (dict(n_pods=2, devices_per_pod=64, stragglers={10: 30.0}, drift_ms_per_kstep=2.0,
          seed=1), dict(period=50, margin=1.3)),
    (dict(n_pods=1, devices_per_pod=1), dict()),
])
def test_canary_prober_verdicts_match_reference(kw, probe):
    """tests/test_substrates.py's canary scenarios: every verdict of 400 steps
    identical, the straggler caught, the timeout following the drift."""
    ref = ref_straggler.CanaryProber(ref_straggler.ClusterSim(**kw), **probe)
    port = straggler.CanaryProber(straggler.ClusterSim(**kw), **probe)
    verdicts = [port.run_step() for _ in range(400)]
    assert verdicts == [ref.run_step() for _ in range(400)]
    if kw.get("stragglers"):
        assert 10 in verdicts[0]["stragglers"]
        assert verdicts[-1]["timeout_ms"] > verdicts[0]["timeout_ms"]
    sim = straggler.ClusterSim(n_pods=2, devices_per_pod=256)
    assert straggler.conventional_probe_cost(sim) == ref_straggler.conventional_probe_cost(
        ref_straggler.ClusterSim(n_pods=2, devices_per_pod=256)) == 1536
    assert straggler.diva_probe_cost() == ref_straggler.diva_probe_cost() == 3


# ---------------------------------------------------------------- main, checkpoints

@pytest.fixture
def reference_init(monkeypatch):
    """The port's ``main`` starts from the reference's parameters for a seed
    (jax.random and torch draw different numbers)."""
    def init_params(seed, cfg, device=None):
        ref = ref_model.init_params(jax.random.PRNGKey(seed), cfg)
        return model.params_from_numpy(jax.tree.map(np.asarray, ref), device)
    monkeypatch.setattr(model, "init_params", init_params)


SMOKE_FLAGS = ["--arch", ARCH, "--smoke", "--steps", "6", "--batch", "4", "--seq", "32",
               "--log-every", "1"]


def test_train_main_matches_reference(reference_init, capsys):
    want = ref_main(SMOKE_FLAGS)
    got = train_mod.main(SMOKE_FLAGS + ["--device", "cpu"])
    assert len(got["losses"]) == len(want["losses"]) == 6 and len(got["step_s"]) == 6
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=STEP_TOL)
    assert got["final_loss"] == got["losses"][-1]
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("step")]
    assert len(lines) == 12 and lines[6].startswith("step     1 loss")


def test_train_main_reduces_loss():
    """tests/test_system.py's check on the port: 60 steps lower the loss."""
    out = train_mod.main(["--arch", ARCH, "--smoke", "--steps", "60", "--batch", "8",
                          "--seq", "48", "--log-every", "10", "--device", "cpu"])
    losses = out["losses"]
    assert losses[-1] < losses[0] - 0.1, losses


def test_train_main_resume_matches_reference(reference_init, tmp_path):
    flags = ["--arch", ARCH, "--smoke", "--batch", "2", "--seq", "16", "--log-every", "1",
             "--ckpt-every", "2"]
    runs = {}
    for name, fn, extra in (("ref", ref_main, []), ("port", train_mod.main, ["--device", "cpu"])):
        d = str(tmp_path / name)
        first = fn(flags + ["--steps", "4", "--ckpt-dir", d] + extra)
        second = fn(flags + ["--steps", "6", "--ckpt-dir", d, "--resume"] + extra)
        runs[name] = first["losses"] + second["losses"]
    assert len(runs["port"]) == 4 + 2
    np.testing.assert_allclose(runs["port"], runs["ref"], rtol=STEP_TOL)


def test_checkpoint_resume_continuity(smoke, tmp_path):
    """Save at step k, restore, continue: the same stream as uninterrupted."""
    cfg, _, port_params = smoke
    step = steps.make_train_step(cfg, warmup=1, base_lr=1e-3)
    state = _state(port_params, get_optimizer(cfg.optimizer))
    batches = [make_batch(cfg, 2, 16, seed=9, step=i) for i in range(4)]
    s = state
    for b in batches:
        s, m = step(s, b)
    s2 = state
    for b in batches[:2]:
        s2, _ = step(s2, b)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(2, s2, device="cpu")
    s3, info = mgr.restore(state, device="cpu")
    assert info == {"step": 2, "corrected_codewords": 0} and int(s3["step"]) == 2
    for b in batches[2:]:
        s3, m3 = step(s3, b)
    assert float(m3["loss"]) == float(m["loss"])
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(s3), tree_leaves(s)))


def test_train_checkpoints_restore_across_packages(smoke, tmp_path):
    """A train state saved by either package restores in the other, leaf for
    leaf: the layout is jax's sorted-key flattening of the nested dict."""
    cfg, ref_params, port_params = smoke
    port_state = _state(port_params, get_optimizer(cfg.optimizer))
    port_state, _ = steps.make_train_step(cfg, warmup=1)(port_state,
                                                          make_batch(cfg, 2, 8, seed=1, step=0))
    ref_opt = ref_get_optimizer(cfg.optimizer)
    ref_state = {"params": ref_params, "opt": ref_opt.init(ref_params),
                 "step": jnp.zeros((), jnp.int32)}
    CheckpointManager(str(tmp_path / "port")).save(1, port_state, device="cpu")
    got, info = RefCheckpointManager(str(tmp_path / "port")).restore(ref_state)
    assert info["step"] == 1
    for a, b in zip(jax.tree.leaves(got), tree_leaves(port_state)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    ref_state = jax.tree.map(np.asarray, ref_state)
    RefCheckpointManager(str(tmp_path / "ref")).save(5, ref_state)
    back, info = CheckpointManager(str(tmp_path / "ref")).restore(port_state, device="cpu")
    assert info["step"] == 5
    for a, b in zip(tree_leaves(back), jax.tree.leaves(ref_state)):
        assert a.dtype == torch.from_numpy(np.array(b)).dtype
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_train_main_refuses_what_is_not_ported(capsys):
    # the production mesh needs 256 ranks; one process raises in both packages
    with pytest.raises(ValueError, match="needs 256 ranks"):
        train_mod.main(["--smoke", "--production-mesh", "--device", "cpu"])
    with pytest.raises(ValueError, match=r"\(16, 16\)"):
        ref_main(["--smoke", "--production-mesh"])
    # the hybrid family is ported: a Jamba step trains
    out = train_mod.main(["--arch", "jamba-1.5-large-398b", "--smoke", "--steps", "1",
                          "--batch", "1", "--seq", "8", "--device", "cpu"])
    assert len(out["losses"]) == 1 and np.isfinite(out["losses"][0])
    if not torch.cuda.is_available():   # no card: ``main`` does not fall back
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_mod.main(["--smoke", "--steps", "1"])


def test_configs_carry_the_training_defaults():
    cfg = get_smoke_config(ARCH)
    assert dataclasses.asdict(cfg)["remat"] == "full" and cfg.optimizer == "adamw"

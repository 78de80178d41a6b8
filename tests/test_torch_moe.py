"""The port's MoE FFN (local path) against the reference on the CPU:
``expert_capacity`` over a grid of sizes, ``_route``'s decisions (expert
ids, positions within each expert, which assignments the capacity keeps)
and its gates and aux loss, ``_dispatch_compute_combine`` over all experts
and over a slice of them (the reference's expert-parallel paths call it with
a slice), ``moe_ffn`` with and without dropped tokens, its gradients, and
the parameters' layout.  Inputs come from a seed with numpy; the
reference's parameters go through ``params_from_numpy``.

Tolerances (float32):
- capacities, expert ids, positions and kept masks: identical;
- gates and aux: rtol = atol = 1e-6 (2.4e-7 measured);
- ``moe_ffn`` and ``_dispatch_compute_combine``: rtol = atol = 1e-5 (4.8e-7
  measured);
- gradients: within 2e-4 of each leaf's largest |reference gradient|
  (tests/test_torch_train.py's bound; 5.0e-7 measured).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs.registry import get_smoke_config as ref_smoke
from repro.models import moe as ref_moe
from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.models import layers, model
from repro_torch.models import moe
from repro_torch.tree import tree_leaves, tree_map

ARCHS = ("moonshot-v1-16b-a3b", "kimi-k2-1t-a32b")
GATE_TOL = 1e-6
FFN_TOL = 1e-5
GRAD_TOL = 2e-4


def _np(t):
    return t.detach().float().numpy()


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), rtol=tol, atol=tol)


def _params(cfg, seed=0):
    ref = ref_moe.moe_params(jax.random.PRNGKey(seed), cfg, jnp.float32)
    return ref, model.params_from_numpy(jax.tree.map(np.asarray, ref), "cpu")


def _tokens(T, D, seed, scale=1.0):
    return np.random.default_rng(seed).normal(0, scale, (T, D)).astype(np.float32)


# ------------------------------------------------------------ capacity

@pytest.mark.parametrize("arch", ARCHS)
def test_expert_capacity_matches_reference_on_a_grid(arch):
    for cf in (0.1, 0.5, 1.0, 1.25, 2.0, 3.3):
        for E, K in ((8, 2), (64, 6), (384, 8), (7, 3)):
            cfg = get_config(arch).replace(n_experts=E, experts_per_token=K,
                                           capacity_factor=cf)
            ref_cfg = ref_smoke(arch).replace(n_experts=E, experts_per_token=K,
                                              capacity_factor=cf)
            for T in (1, 2, 7, 8, 63, 64, 100, 512, 4096, 4097, 65536):
                got = moe.expert_capacity(cfg, T)
                assert got == ref_moe.expert_capacity(ref_cfg, T), (cf, E, K, T)
                assert got >= 8 and got % 8 == 0


# ------------------------------------------------------------ routing

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("T,seed", [(1, 0), (6, 1), (48, 2), (200, 3)])
def test_route_decisions_match_reference(arch, T, seed):
    cfg = get_smoke_config(arch)
    ref_p, p = _params(cfg, seed)
    xt = _tokens(T, cfg.d_model, seed + 10)
    fe_j, pos_j, gate_j, aux_j = ref_moe._route(cfg, jnp.asarray(xt), ref_p["wr"])
    fe_t, pos_t, gate_t, aux_t = moe._route(cfg, torch.from_numpy(xt), p["wr"])
    np.testing.assert_array_equal(fe_t.numpy(), np.asarray(fe_j))
    np.testing.assert_array_equal(pos_t.numpy(), np.asarray(pos_j))
    C = moe.expert_capacity(cfg, T)
    np.testing.assert_array_equal((pos_t < C).numpy(), np.asarray(pos_j) < C)
    assert gate_t.dtype == aux_t.dtype == torch.float32
    _close(gate_t, gate_j, GATE_TOL)
    _close(aux_t, aux_j, GATE_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_route_breaks_ties_toward_the_lower_expert(arch):
    """Equal router probabilities (zero tokens, duplicated router columns):
    ``jax.lax.top_k`` takes the lower index first, and so does the port."""
    cfg = get_smoke_config(arch)
    ref_p, _ = _params(cfg)
    wr = np.asarray(ref_p["wr"]).copy()
    wr[:, 5] = wr[:, 2]
    wr[:, 7] = wr[:, 2]
    xt = _tokens(12, cfg.d_model, 4)
    xt[:4] = 0.0                                   # all experts tie
    fe_j, pos_j, gate_j, _ = ref_moe._route(cfg, jnp.asarray(xt), jnp.asarray(wr))
    fe_t, pos_t, gate_t, _ = moe._route(cfg, torch.from_numpy(xt), torch.from_numpy(wr))
    np.testing.assert_array_equal(fe_t.numpy(), np.asarray(fe_j))
    np.testing.assert_array_equal(pos_t.numpy(), np.asarray(pos_j))
    K = cfg.experts_per_token
    assert fe_t[:4 * K].tolist() == list(range(K)) * 4
    _close(gate_t, gate_j, GATE_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_positions_are_first_come_first_served(arch):
    cfg = get_smoke_config(arch)
    _, p = _params(cfg, 1)
    fe, pos, _, _ = moe._route(cfg, torch.from_numpy(_tokens(64, cfg.d_model, 5)), p["wr"])
    for e in range(cfg.n_experts):
        mine = pos[fe == e]
        assert mine.tolist() == list(range(len(mine)))


# ------------------------------------------------------------ the FFN

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("e_start,E_loc", [(0, 8), (2, 3), (6, 2)])
def test_dispatch_compute_combine_matches_reference(arch, e_start, E_loc):
    cfg = get_smoke_config(arch)
    ref_p, p = _params(cfg, 2)
    xt = _tokens(40, cfg.d_model, 6)
    C = 8
    fe_j, pos_j, gate_j, _ = ref_moe._route(cfg, jnp.asarray(xt), ref_p["wr"])
    want = ref_moe._dispatch_compute_combine(
        cfg, jnp.asarray(xt), ref_p["wei"][e_start:e_start + E_loc],
        ref_p["weg"][e_start:e_start + E_loc], ref_p["weo"][e_start:e_start + E_loc],
        fe_j, pos_j, gate_j, C, e_start, E_loc)
    fe_t, pos_t, gate_t, _ = moe._route(cfg, torch.from_numpy(xt), p["wr"])
    sl = slice(e_start, e_start + E_loc)
    got = moe._dispatch_compute_combine(cfg, torch.from_numpy(xt), p["wei"][sl],
                                        p["weg"][sl], p["weo"][sl], fe_t, pos_t, gate_t,
                                        C, e_start, E_loc)
    _close(got, want, FFN_TOL)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("capacity_factor,B,S", [(1.25, 2, 9), (1.25, 1, 1), (0.2, 4, 32),
                                                  (0.05, 2, 64)])
def test_moe_ffn_matches_reference(arch, capacity_factor, B, S):
    """With a small capacity factor, assignments past an expert's capacity
    are dropped: the same ones in both packages."""
    cfg = get_smoke_config(arch).replace(capacity_factor=capacity_factor)
    ref_p, p = _params(cfg, 3)
    x = np.random.default_rng(B * S).normal(0, 1, (B, S, cfg.d_model)).astype(np.float32)
    want, aux_j = ref_moe.moe_ffn(cfg, ref_p, jnp.asarray(x))
    got, aux_t = moe.moe_ffn(cfg, p, torch.from_numpy(x))
    assert got.shape == (B, S, cfg.d_model) and aux_t.dtype == torch.float32
    _close(got, want, FFN_TOL)
    _close(aux_t, aux_j, GATE_TOL)
    if capacity_factor < 1:
        xt = torch.from_numpy(x.reshape(B * S, -1))
        h = layers.apply_norm(cfg, p["ln"], xt)
        _, pos, _, _ = moe._route(cfg, h, p["wr"])
        assert bool((pos >= moe.expert_capacity(cfg, B * S)).any())   # some dropped


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_gradients_match_reference(arch):
    cfg = get_smoke_config(arch).replace(capacity_factor=0.5)
    ref_p, p = _params(cfg, 4)
    x = np.random.default_rng(8).normal(0, 1, (2, 24, cfg.d_model)).astype(np.float32)
    w = np.random.default_rng(9).normal(0, 1, (2, 24, cfg.d_model)).astype(np.float32)

    def ref_loss(params, xx):
        out, aux = ref_moe.moe_ffn(cfg, params, xx)
        return jnp.sum(out * w) + aux

    want_p, want_x = jax.grad(ref_loss, argnums=(0, 1))(ref_p, jnp.asarray(x))
    params = tree_map(lambda a: a.clone().requires_grad_(), p)
    xt = torch.from_numpy(x).requires_grad_()
    out, aux = moe.moe_ffn(cfg, params, xt)
    (torch.sum(out * torch.from_numpy(w)) + aux).backward()
    pairs = list(zip(tree_leaves(params), jax.tree.leaves(want_p))) + [(xt, want_x)]
    for got, want in pairs:
        want = np.asarray(want, np.float32)
        np.testing.assert_allclose(got.grad.numpy(), want, rtol=0,
                                   atol=GRAD_TOL * float(np.abs(want).max()))


def test_bfloat16_routes_in_float32():
    """In bfloat16 compute the router still runs in float32 (``wr`` is kept
    float32 and the tokens are cast up): routing equals the reference's on
    the same bfloat16 inputs, and the FFN's output is bfloat16."""
    cfg = get_smoke_config("moonshot-v1-16b-a3b").replace(compute_dtype="bfloat16")
    ref_p, p = _params(cfg, 5)
    bf = model.cast_params(p, cfg)
    assert bf["wr"].dtype == torch.float32 and bf["wei"].dtype == torch.bfloat16
    assert bf["ln"]["scale"].dtype == torch.float32
    x = _tokens(30, cfg.d_model, 7)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    xt = torch.from_numpy(x).bfloat16()
    fe_j, pos_j, _, _ = ref_moe._route(cfg, xj, ref_p["wr"])
    fe_t, pos_t, _, _ = moe._route(cfg, xt, bf["wr"])
    np.testing.assert_array_equal(fe_t.numpy(), np.asarray(fe_j))
    np.testing.assert_array_equal(pos_t.numpy(), np.asarray(pos_j))
    out, aux = moe.moe_ffn(cfg, bf, xt.reshape(1, 30, -1))
    assert out.dtype == torch.bfloat16 and aux.dtype == torch.float32


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_params_have_the_reference_layout(arch):
    cfg = get_smoke_config(arch).replace(d_model=128, d_ff=64, n_layers=4)
    pdt = torch.bfloat16
    got = moe.moe_params(torch.Generator().manual_seed(0), cfg, pdt, lead=(3,))
    want = jax.vmap(lambda k: ref_moe.moe_params(k, cfg, jnp.bfloat16))(
        jax.random.split(jax.random.PRNGKey(0), 3))
    layout = lambda t: {k: layout(v) if isinstance(v, dict) else
                        (tuple(v.shape), str(v.dtype).replace("torch.", ""))
                        for k, v in t.items()}
    assert layout(got) == layout(want)
    assert got["wr"].dtype == torch.float32            # the router is drawn in float32
    D, F_ = cfg.d_model, cfg.d_ff
    assert abs(float(got["wei"].float().std()) * D ** 0.5 - 1) < 0.05
    assert abs(float(got["weo"].float().std()) * (F_ * cfg.n_layers) ** 0.5 - 1) < 0.05

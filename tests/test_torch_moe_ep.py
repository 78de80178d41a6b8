"""The expert-parallel MoE paths (``_moe_ffn_ep``, ``_moe_ffn_a2a``) in the
port's sharded train step against the reference's sharded step on the same
mesh, on ``get_smoke_config("moonshot-v1-16b-a3b")`` (8 experts, top-2,
capacity 1.25, AdamW, float32).

A sharded MoE step is not the unsharded one: capacity is taken of each
batch shard's tokens, drops are decided per shard, the aux loss is the mean
of the shards' values, and a2a also splits the sequence over "model".  So
the port runs on gloo ranks (``torch_mesh_ranks.spawn``) and the reference
on as many forced host devices in a subprocess, from the same parameters,
3 steps of ``SyntheticLM(cfg, 4, 32, seed=0)`` with
``make_train_step(cfg, total_steps=100, warmup=0)``.

Tolerances (float32; XLA sums in other orders):
- loss, ce, aux, gnorm, lr: rtol 1e-5 at every step; identical on every rank;
- the parameters after step 3: atol 2e-5 (1.7e-5 measured on (4, 1), on one
  element of ``embed/tok``: a token whose gradient, ~1.7e-8, is below
  AdamW's eps, so the two summation orders move it apart most);
- every rank's expert ids and positions identical to the reference's shard.
"""
import pytest

torch = pytest.importorskip("torch")

import torch_mesh_ranks as ranks
from repro_torch.configs.registry import get_smoke_config

ARCH = "moonshot-v1-16b-a3b"
STEP_TOL, PARAM_ATOL = 1e-5, 2e-5


@pytest.mark.parametrize("mesh", [(2, 2), (4, 1), (1, 4)])
def test_ep_step_matches_reference_on_the_mesh(mesh, tmp_path):
    out = ranks.run_parity(ARCH, mesh, tmp_path)
    ranks.check_parity(out, step_tol=STEP_TOL, param_atol=PARAM_ATOL)
    # every rank routed: two layers, three steps (and the backward's recompute)
    assert all(len(r["routes"]) >= 6 for r in out["port"])


@pytest.mark.parametrize("mesh", [(1, 2), (2, 2)])
def test_a2a_step_matches_reference_on_the_mesh(mesh, tmp_path):
    out = ranks.run_parity(ARCH, mesh, tmp_path, a2a=True)
    ranks.check_parity(out, step_tol=STEP_TOL, param_atol=PARAM_ATOL)
    # each model rank routed its own slice of the sequence
    T = ranks.BATCH // mesh[0] * ranks.SEQ // mesh[1]
    K = get_smoke_config(ARCH).experts_per_token
    assert all(r["routes"][0][0].shape == (T * K,) for r in out["port"])


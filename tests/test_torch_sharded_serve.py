"""The port's sharded prefill and decode steps
(``launch.steps.make_sharded_prefill_step`` / ``make_sharded_decode_step``)
against the reference's jitted prefill and decode with the dry run's
shardings (``repro/launch/dryrun.py``: parameters by ``param_shardings``,
the batch by ``data_spec``, the cache by ``cache_shardings``), on meshes
(2, 1) and (1, 2): the port on 2 gloo ranks (``torch_mesh_ranks.spawn``),
the reference on 2 forced host devices in a subprocess, both from the
reference's parameters, ``qwen2-0.5b`` and ``moonshot-v1-16b-a3b`` (8
experts over "model" on (1, 2): the expert-parallel path) at smoke widths,
4 prompts of 12 tokens into caches of 16 positions, then 3 greedy steps.

Bounds (float32; XLA sums in other orders): the prefill's logits and every
float cache leaf within rtol 1e-5 (and 1e-5 of the leaf's largest |value|,
for the elements near 0); greedy tokens, positions identical.  The port's
caches are gathered whole from the ranks of "model" index 0 (each rank holds
its batch shard with whole heads); the reference's come back whole.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_mesh_ranks as ranks

ARCHS = ("qwen2-0.5b", "moonshot-v1-16b-a3b")
RTOL = 1e-5
CASES = [(a, m) for a in ARCHS for m in ranks.SERVE_MESHES]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return ranks.run_serve(ARCHS, tmp_path_factory.mktemp("serve"))


def _whole(port, key, field, batch_dim=0):
    """``field`` of every rank of "model" index 0, concatenated over the
    batch in "data" order (a dict of cache leaves: each leaf on its batch
    dim)."""
    mine = sorted((r[key]["coords"], r[key][field]) for r in port if r[key]["coords"][1] == 0)
    parts = [v for _, v in mine]
    if isinstance(parts[0], dict):
        return {k: np.concatenate([p[k] for p in parts], _cache_batch_dim(k))
                if len(parts) > 1 and _cache_batch_dim(k) is not None else parts[0][k]
                for k in parts[0]}
    return np.concatenate(parts, batch_dim)


def _cache_batch_dim(key: str):
    return None if key == "pos" else 1


def _close(got, want, what):
    assert got.shape == want.shape and got.dtype == want.dtype, what
    if np.issubdtype(want.dtype, np.floating):
        scale = float(np.abs(want).max()) if want.size else 0.0
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * scale, err_msg=what)
    else:
        np.testing.assert_array_equal(got, want, err_msg=what)


def test_ranks_ran_without_jax(runs):
    assert all(r["loaded"] == [] for r in runs["port"])


@pytest.mark.parametrize("arch,mesh", CASES)
def test_prefill_logits_match_reference(runs, arch, mesh):
    key = f"{arch} {mesh}"
    got = _whole(runs["port"], key, "logits")
    _close(got, runs["ref"][key]["logits"], f"{key} logits")
    # ranks of one "data" index compute the same shard
    by_data = {}
    for r in runs["port"]:
        d = r[key]["coords"][0]
        if d in by_data:
            np.testing.assert_array_equal(r[key]["logits"], by_data[d])
        by_data[d] = r[key]["logits"]


@pytest.mark.parametrize("arch,mesh", CASES)
def test_greedy_tokens_match_reference(runs, arch, mesh):
    key = f"{arch} {mesh}"
    want = runs["ref"][key]["tokens"]
    mine = sorted((r[key]["coords"], r[key]["tokens"]) for r in runs["port"]
                  if r[key]["coords"][1] == 0)
    for i in range(ranks.SERVE_DECODE + 1):
        got = np.concatenate([t[i] for _, t in mine])
        np.testing.assert_array_equal(got, want[i], err_msg=f"{key} step {i}")


@pytest.mark.parametrize("when", ["cache_prefill", "cache_final"])
@pytest.mark.parametrize("arch,mesh", CASES)
def test_caches_match_reference_gathered_whole(runs, arch, mesh, when):
    key = f"{arch} {mesh}"
    got, want = _whole(runs["port"], key, when), runs["ref"][key][when]
    assert sorted(got) == sorted(want)
    for leaf in want:
        _close(got[leaf], want[leaf], f"{key} {when} {leaf}")
    assert int(got["pos"]) == ranks.SERVE_PROMPT + (ranks.SERVE_DECODE if when ==
                                                    "cache_final" else 0)

"""The port's sharded train step and sharded checkpoints against the
reference on the same mesh, over 4 gloo ranks (``torch_mesh_ranks``): dense
``qwen2-0.5b`` and ``kimi-k2-1t-a32b`` (Adafactor + MoE: the factored second
moments over a split dim are summed over its axis) on (2, 2), 3 steps from
the reference's parameters against the reference's jitted step with
``state_shardings`` / ``batch_shardings`` on 4 forced host devices; the five
collectives' values and gradients; a mesh over the first 3 of 4 ranks; a
sharded save on (2, 2) restored onto (2, 2) from the shards as the example,
onto (4, 1), onto one process, and by the reference's ``CheckpointManager``.

Tolerances: metrics rtol 1e-5 at every step and identical on every rank,
parameters atol 2e-5 after step 3 (``test_torch_train.py``'s), routing
identical per shard; collectives and checkpoints exact.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

import torch_mesh_ranks as ranks
from repro.checkpoint import CheckpointManager as RefCheckpointManager
from repro_torch import sharding as shd
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.registry import get_smoke_config
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.train import build_state
from repro_torch.tree import tree_leaves

STEP_TOL, PARAM_ATOL = 1e-5, 2e-5


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "kimi-k2-1t-a32b"])
def test_sharded_step_matches_reference_on_2x2(arch, tmp_path):
    out = ranks.run_parity(arch, (2, 2), tmp_path)
    ranks.check_parity(out, step_tol=STEP_TOL, param_atol=PARAM_ATOL)


@pytest.fixture(scope="module")
def misc(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("misc")
    return tmp, ranks.spawn("misc_rank", 4, tmp / "ranks", str(tmp))


def _want_collective(name, xs, ws, m):
    """What each collective must give rank m of a 2-rank axis, from every
    rank's input ``xs`` and cotangent weights ``ws`` (the forward's output
    times ``ws``, summed, is differentiated)."""
    if name == "copy":
        return xs[m], ws[0] + ws[1]
    if name == "reduce":
        return xs[0] + xs[1], ws[m]
    if name == "split":
        return xs[m][2 * m:2 * m + 2], np.concatenate([ws[0], ws[1]], 0)
    if name == "gather":
        return np.concatenate(xs, 1), ws[m][:, 3 * m:3 * m + 3]
    # a2a: block j of the output comes from rank j's block m
    x3 = [x.reshape(2, 2, 3) for x in xs]
    w3 = [w.reshape(2, 2, 3) for w in ws]
    return np.stack([x3[0][m], x3[1][m]]), np.stack([w3[0][m], w3[1][m]]).reshape(4, 3)


def test_collectives_and_their_gradients(misc):
    _, results = misc
    by_m: dict = {}
    for r in results:
        m, got = r["collectives"]
        by_m.setdefault(m, got)
    xs = [np.arange(12.0, dtype=np.float32).reshape(4, 3) * (m + 1) for m in (0, 1)]
    for name in ("copy", "reduce", "split", "gather", "a2a"):
        ys = [by_m[m][name][0] for m in (0, 1)]
        ws = [np.arange(y.size, dtype=np.float32).reshape(y.shape) + 10 * m
              for m, y in enumerate(ys)]
        for m in (0, 1):
            y, g = by_m[m][name]
            want_y, want_g = _want_collective(name, xs, ws, m)
            np.testing.assert_array_equal(y, want_y, err_msg=f"{name} value, rank {m}")
            np.testing.assert_array_equal(g, want_g.reshape(g.shape),
                                          err_msg=f"{name} gradient, rank {m}")


def test_mesh_over_the_first_ranks(misc):
    _, results = misc
    assert [r["sub"] for r in results] == [{"data": 3, "model": 1}] * 3 + [None]


def test_sharded_restore_takes_the_shards_as_its_example(misc):
    _, results = misc
    assert [r["restore_self"] for r in results] == [True] * 4


def test_sharded_checkpoint_lands_on_another_mesh(misc):
    tmp, results = misc
    full = build_state(get_smoke_config("moonshot-v1-16b-a3b"), seed=5, device="cpu")
    n = sum(x.numel() for x in tree_leaves(full))
    # onto (4, 1): each rank's shards equal to its slices, a quarter of the
    # split leaves each
    assert all(r["restore"][:2] == (7, True) for r in results)
    assert sum(r["restore"][2] for r in results) > n
    # onto one process
    mgr = CheckpointManager(str(tmp / "ckpt"))
    host = steps.state_shardings(full, make_host_mesh(device="cpu"))
    back, info = mgr.restore(full, shardings=host)
    assert info == {"step": 7, "corrected_codewords": 0}
    for a, b in zip(tree_leaves(back), tree_leaves(full)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # by the reference
    ref_example = jax.tree.map(lambda t: np.zeros(t.shape, t.numpy().dtype), full)
    got, info = RefCheckpointManager(str(tmp / "ckpt")).restore(ref_example)
    assert info["step"] == 7
    for a, b in zip(jax.tree.leaves(got), tree_leaves(full)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())

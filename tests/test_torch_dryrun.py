"""The port's dry run and roofline (``repro_torch.launch.dryrun``,
``roofline``, ``roofline_report``, ``steps.input_specs`` /
``abstract_state`` / ``abstract_cache``) against the reference's.

- All 40 (arch x shape) cells: the input specs' shapes and dtypes, the
  parameter counts (total and MoE-active), the tokens a step and
  ``shape_applicable`` exactly the reference's; every leaf of the train
  state the reference's shape; every cache leaf of the decode shapes the
  reference's shape and dtype.
- The report's rows string for string with the reference's, its peak and
  memory budget set to the H100's.
- Counting: a Mamba scan traced by standing steps on fake tensors counts
  what the whole loop counts on real ones (ops, FLOPs by dtype, bytes),
  forward and backward, chunked and not, and its memory peak within 5%
  (the standing step's storages weigh as the n - 2 steps' at once; a few
  of the backward's transients do not: 2-3% low measured); ``wkv6`` /
  ``wkv6_bwd`` count the kernels' work on fake tensors as on real ones,
  every step of it; a counting mesh's collectives count their operands and
  take fake tensors only.
- Whole cells through ``run_cell`` on the production meshes' rank 0, and
  ``main`` and the report end to end on a skip and an ok cell.
Nothing here starts ``torch.distributed``.
"""
import contextlib
import functools
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import base as ref_base
from repro.configs.registry import get_config as ref_get_config
from repro.launch import roofline as ref_roofline
from repro.launch import roofline_report as ref_report
from repro.launch import steps as ref_steps
from repro_torch import sharding as shd
from repro_torch.configs.base import SHAPES, shape_applicable
from repro_torch.configs.registry import ARCH_IDS, get_config, get_smoke_config
from repro_torch.counting import WorkCounter
from repro_torch.kernels import wkv6 as wkv_mod
from repro_torch.launch import dryrun, roofline, roofline_report, steps
from repro_torch.models import mamba, model
from repro_torch.tree import tree_leaves, tree_map_with_path, tree_unflatten

CELLS = [(a, s) for a in ARCH_IDS for s in SHAPES]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The real loops here are many small ops: one intra-op thread runs them
    as fast and leaves the host's cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
DECODE = [(a, s) for a in ARCH_IDS for s in SHAPES if SHAPES[s].kind == "decode"]


def _paths(tree) -> dict:
    return dict(tree_leaves(tree_map_with_path(lambda p, leaf: ("/".join(p), leaf), tree)))


def _ref_paths(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(k, "key", k)) for k in path): leaf for path, leaf in flat}


@functools.cache
def _ref_state(arch):
    return ref_steps.abstract_state(ref_get_config(arch))


@functools.cache
def _port_params(arch):
    return steps.abstract_state(get_config(arch))["params"]


def _dtype(t) -> str:
    return str(t.dtype).removeprefix("torch.")


# --------------------------------------------------------------- parity

@pytest.mark.parametrize("arch,shape", CELLS)
def test_specs_counts_and_applicability_match_reference(arch, shape):
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    sh, rsh = SHAPES[shape], ref_base.SHAPES[shape]
    assert shape_applicable(cfg, sh) == ref_base.shape_applicable(rcfg, rsh)
    got, want = steps.input_specs(cfg, sh), ref_steps.input_specs(rcfg, rsh)
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape and _dtype(got[k]) == str(want[k].dtype), k
        assert isinstance(got[k], torch._subclasses.fake_tensor.FakeTensor)
    assert roofline.tokens_per_step(cfg, sh) == ref_roofline.tokens_per_step(rcfg, rsh)
    params, rparams = _port_params(arch), _ref_state(arch)["params"]
    assert roofline.param_count(params) == ref_roofline.param_count(rparams)
    assert roofline.active_param_count(params, cfg) == \
        ref_roofline.active_param_count(rparams, rcfg)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_state_leaf_shapes_match_reference(arch):
    got = _paths(steps.abstract_state(get_config(arch)))
    want = _ref_paths(_ref_state(arch))
    assert sorted(got) == sorted(want)
    for k, leaf in want.items():
        assert tuple(got[k].shape) == leaf.shape, k


@pytest.mark.parametrize("arch,shape", DECODE)
def test_abstract_cache_leaves_match_reference(arch, shape):
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    got = _paths(steps.abstract_cache(cfg, SHAPES[shape]))
    want = _ref_paths(ref_steps.abstract_cache(rcfg, ref_base.SHAPES[shape]))
    assert sorted(got) == sorted(want)
    for k, leaf in want.items():
        assert tuple(got[k].shape) == leaf.shape and _dtype(got[k]) == str(leaf.dtype), k


# --------------------------------------------------------------- report rows

def _record(shape="train_4k", **kw):
    rec = {"arch": "qwen2-0.5b", "shape": shape, "status": "ok", "reason": "",
           "n_chips": 256, "model_flops": 3.1e15, "flops_per_device": 3.2e14,
           "memory": {"argument_size_in_bytes": 23968320, "output_size_in_bytes": 23707648,
                      "alias_size_in_bytes": 1000},
           "roofline": {"t_compute_s": 1.61, "t_memory_s": 5.31, "t_collective_s": 0.042,
                        "dominant": "memory", "roofline_frac": 0.303}}
    rec.update(kw)
    return rec


@pytest.mark.parametrize("rec", [
    _record(),
    _record("decode_32k", n_chips=512),
    _record(memory={"argument_size_in_bytes": 95e9, "output_size_in_bytes": 2e9,
                    "alias_size_in_bytes": 0}),
    {"arch": "qwen2-0.5b", "shape": "long_500k", "status": "skip",
     "reason": "long_500k skipped: pure full-attention arch (no sub-quadratic path)"},
], ids=["train", "decode", "over_hbm", "skip"])
def test_report_rows_match_reference(rec, monkeypatch):
    monkeypatch.setattr(ref_report, "PEAK_FLOPS", roofline.PEAK_FLOPS)
    monkeypatch.setattr(ref_report, "HBM_GB", roofline_report.HBM_GB)
    assert roofline_report.fmt_row(rec) == ref_report.fmt_row(rec)


def test_peaks_are_the_h100s():
    assert roofline.PEAK_FLOPS_BY_DTYPE == {"bfloat16": 989.4e12, "float16": 989.4e12,
                                           "float32": 66.9e12}
    assert (roofline.HBM_BW, roofline.NVLINK_BW, roofline.INTER_NODE_BW) == \
        (3.35e12, 450e9, 50e9)
    assert roofline_report.HBM_GB == 80
    # a float32 FLOP costs 15x a bfloat16 one
    t = roofline.roofline_terms({"float32": 66.9e12, "bfloat16": 989.4e12}, 0, {}, {})
    assert t["t_compute_s"] == pytest.approx(2.0)
    assert roofline.axis_links((16, 16), ("data", "model")) == \
        {"data": "inter-node", "model": "inter-node"}
    assert roofline.axis_links((32, 8), ("data", "model")) == \
        {"data": "inter-node", "model": "nvlink"}
    assert roofline.axis_links((2, 4, 2), ("pod", "data", "model")) == \
        {"pod": "inter-node", "data": "nvlink", "model": "nvlink"}


# --------------------------------------------------------------- counting

def _count(fn, fake: bool, **kw):
    """``fn()`` (which builds its own inputs) under a counter, on fake or
    real CPU tensors: (summary, peak)."""
    torch.manual_seed(0)
    with FakeTensorMode() if fake else contextlib.nullcontext():
        args = fn()
        with WorkCounter(**kw) as c:
            args[0](*args[1:])
    return c.summary(), c.peak


def _mamba_step(S):
    cfg = get_smoke_config("jamba-1.5-large-398b")

    def make():
        p = mamba.mamba_params(torch.Generator().manual_seed(0), cfg, torch.float32)
        leaves = [t.requires_grad_() for t in tree_leaves(p)]
        p = tree_unflatten(p, leaves)
        x = torch.randn((2, S, cfg.d_model), requires_grad=True)

        def run(p, x):
            out, _ = mamba.mamba_block(cfg, p, x)
            torch.autograd.grad(out.square().sum(), [x] + leaves)
        return run, p, x
    return make


@pytest.mark.parametrize("S", [100, 256, 512])
def test_scan_by_standing_steps_counts_the_whole_loop(S):
    # S = 100: one plain loop; S = 256: two checkpointed chunks of 128;
    # S = 512: four, the inner two standing for one another
    real = _count(_mamba_step(S), False, split_activations=True)
    fake = _count(_mamba_step(S), True, split_activations=True)
    assert fake[0] == real[0]
    assert real[0]["flops"]["float32"] > 0
    assert abs(fake[1] - real[1]) <= 0.05 * real[1]


def _rwkv_loss(S):
    cfg = get_smoke_config("rwkv6-1.6b")

    def make():
        params = model.init_params(0, cfg, device="cpu")
        leaves = [t.requires_grad_() for t in tree_leaves(params)]
        params = tree_unflatten(params, leaves)
        tokens = torch.zeros((2, S + 1), dtype=torch.int32)

        def run(params, tokens):
            loss, _ = model.loss_fn(cfg, params, {"tokens": tokens})
            torch.autograd.grad(loss, leaves)
        return run, params, tokens
    return make, cfg


@pytest.mark.parametrize("S", [1, 9, 16])
def test_wkv6_counts_the_kernels_work_on_fake_tensors(S):
    make, cfg = _rwkv_loss(S)
    real, fake = _count(make, False), _count(make, True)
    # the fake path also holds the backward kernel's scratch, as a card does
    assert fake[0] == real[0] and fake[1] >= real[1]
    k = real[0]["kernels"]
    L, H, dh = cfg.n_layers, cfg.rwkv_heads, cfg.rwkv_head_dim
    # forward, the remat's recompute and the backward: every step counted
    assert k["wkv6"]["calls"] == 2 * L and k["wkv6_bwd"]["calls"] == L
    per = 2 * H * S * (wkv_mod.WKV_FLOPS_PER_IJ * dh * dh + wkv_mod.WKV_FLOPS_PER_I * dh)
    assert k["wkv6"]["flops"] == 2 * L * per
    bwd = 2 * H * S * (wkv_mod.WKV_BWD_FLOPS_PER_IJ * dh * dh
                       + wkv_mod.WKV_BWD_FLOPS_PER_I * dh)
    assert k["wkv6_bwd"]["flops"] == L * bwd


def test_wkv6_work_formulas():
    r = torch.zeros((8, 512, 32, 64))
    u = torch.zeros((32, 64))
    s0 = torch.zeros((8, 32, 64, 64))
    n = 8 * 512 * 32 * 64
    state = 8 * 32 * 64 * 64
    assert wkv_mod.wkv6_work(r, r, r, r, u) == \
        (4 * (4 * n + 32 * 64 + n + state), 8 * 32 * 512 * (5 * 64 * 64 + 8 * 64))
    assert wkv_mod.wkv6_work(r, r, r, r, u, s0)[0] == 4 * (4 * n + 32 * 64 + n + 2 * state)
    nb, ops = wkv_mod.wkv6_bwd_work(r, r.bfloat16(), r.bfloat16(), r, u, None, r)
    assert nb == 2 * (4 * n * 2 + 2 * n * 2 + 4 * 32 * 64) + 4 * n
    assert ops == 8 * 32 * 512 * (14 * 64 * 64 + 21 * 64)


def test_counting_mesh_collectives_count_and_take_fake_tensors_only():
    mesh = shd.counting_mesh((2, 4), ("data", "model"), rank=6)
    assert mesh.coords == (1, 2) and mesh.size == 8
    assert shd.counting_mesh((1, 1), ("data", "model")).groups == ()
    shd.reset_collectives()
    with FakeTensorMode():
        x = torch.empty((3, 5))
        shd.all_reduce_(x, mesh, ("data", "model"))
        y = shd.all_gather(x, mesh, ("model",), 1)
        z = shd.all_to_all(torch.empty((4, 2)), mesh, "model")
    assert tuple(y.shape) == (3, 20) and tuple(z.shape) == (4, 2)
    assert shd.COLLECTIVES == {("all-reduce", "data"): [1, 60],
                               ("all-reduce", "model"): [1, 60],
                               ("all-gather", "model"): [1, 60],
                               ("all-to-all", "model"): [1, 32]}
    coll = roofline.collective_bytes(shd.COLLECTIVES)
    assert coll["total"] == 212 and coll["by_axis"] == {"data": 60, "model": 152}
    with pytest.raises(TypeError, match="fake tensors only"):
        shd.all_reduce_(torch.zeros(3), mesh, ("data",))
    shd.reset_collectives()


# --------------------------------------------------------------- whole cells

@pytest.mark.parametrize("arch,shape", [("qwen2-0.5b", "decode_32k"),
                                        ("rwkv6-1.6b", "train_4k"),
                                        ("moonshot-v1-16b-a3b", "prefill_32k")])
def test_run_cell_gives_a_coherent_record(arch, shape):
    rec = dryrun.run_cell(arch, shape, False)
    assert rec["status"] == "ok" and rec["n_chips"] == 256 and rec["trace_s"] > 0
    assert rec["flops_per_device"] > 0 and rec["bytes_per_device"] > 0
    assert rec["device_ops"] > 0
    t = rec["roofline"]
    assert t["dominant"] in ("compute", "memory", "collective")
    assert all(t[k] > 0 for k in ("t_compute_s", "t_memory_s", "t_collective_s"))
    mem = rec["memory"]
    assert mem["peak_bytes"] >= mem["argument_size_in_bytes"] > 0
    assert sum(mem["peak_parts"].values()) == mem["peak_bytes"]
    assert mem["peak_parts"]["gathered"] > 0
    coll = rec["collectives"]
    assert coll["total"] == sum(coll[k] for k in roofline.KINDS) > 0
    if arch == "rwkv6-1.6b":   # train: 24 layers, forward + recompute, backward
        assert rec["kernels"]["wkv6"]["calls"] == 48
        assert rec["kernels"]["wkv6_bwd"]["calls"] == 24
        assert mem["peak_parts"]["activations"] > 0
    if arch == "moonshot-v1-16b-a3b":   # 64 experts over "model": the ep path
        assert coll["counts"]["all-reduce"] > 0 and coll["by_axis"]["model"] > 0
    if shape == "decode_32k":
        assert mem["peak_parts"]["cache"] > 0


def test_main_and_report_end_to_end(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(dryrun, "OUT_DIR", tmp_path)
    monkeypatch.setattr(roofline_report, "OUT_DIR", tmp_path)
    dryrun.main(["--arch", "qwen2-0.5b", "--shape", "long_500k", "--mesh", "multi"])
    dryrun.main(["--arch", "rwkv6-1.6b", "--shape", "long_500k", "--mesh", "single"])
    skip = json.loads((tmp_path / "multi" / "qwen2-0.5b__long_500k.json").read_text())
    assert skip["status"] == "skip" and skip["reason"].startswith("long_500k skipped")
    ok = json.loads((tmp_path / "single" / "rwkv6-1.6b__long_500k.json").read_text())
    assert ok["status"] == "ok" and ok["kernels"]["wkv6"]["calls"] == 24
    roofline_report.main([])
    out = capsys.readouterr().out
    assert "| rwkv6-1.6b | long_500k |" in out and "| qwen2-0.5b | long_500k |" in out
    assert "fits 80GB?" in out
    roofline_report.main(["--summary"])
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 3 and out[2].startswith("| rwkv6-1.6b | long_500k | ")
    assert out[2].endswith("| — | — |")


def test_options_without_a_counterpart_raise():
    with pytest.raises(ValueError, match="no counterpart"):
        dryrun.run_cell("qwen2-0.5b", "decode_32k", False, opts=("seq-shard",))
    for flag in ("--scan", "--save-hlo"):
        with pytest.raises(SystemExit, match="no counterpart"):
            dryrun.main([flag])
    assert np.isclose(roofline.PEAK_FLOPS / 1e12, 989.4)

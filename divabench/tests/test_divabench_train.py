"""The training cell (``rwkv6.train``) on the CPU at a tiny RWKV-6 cut here
only (2 layers, d_model 64, vocabulary 256): the port's loss and gradients
and its train steps against ``reference_rwkv6.py``, the entry's round trip
through the harness, faults under the timed path, what the reference loads,
the yardstick's FLOP count against the port's ``WorkCounter``, and the
manifest's entries."""
import dataclasses
import json
import os
import subprocess
import sys
import time

import pytest
import torch

from divabench import harness
from divabench import reference_rwkv6 as ref
from divabench import roofline_rwkv6 as roof
from divabench.control import readings
from divabench.entries import train_step as entry
from divabench_cells import manifest

CELL = "rwkv6.train"
TINY = {"n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 4,
        "rwkv_head_dim": 16, "d_ff": 224, "vocab_size": 256,
        "rwkv_decay_lora": 8}
SEED = 2**33 + 21


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def tiny_cell(compute: str = "float32", batch: int = 4,
              seq: int = 16) -> harness.Cell:
    cell = harness.Cell.load(manifest(), CELL)
    model = dict(cell.config["model"], **TINY, compute_dtype=compute)
    return dataclasses.replace(
        cell, config=dict(cell.config, model=model),
        traffic=dict(cell.traffic, batch=batch, seq=seq))


def _port_cfg(cell):
    from repro_torch.configs.registry import get_config
    return get_config(cell.config["arch_id"]).replace(**cell.config["model"])


def test_loss_and_gradients_match_the_port():
    """One forward and backward of the port (float32) and of the reference
    on the same weights and tokens: the loss and every gradient leaf."""
    from repro_torch.models import model as model_mod
    cell = tiny_cell()
    model = entry.model_of(cell.config)
    cfg = _port_cfg(cell)
    params = ref.init_params(model, SEED, "cpu")
    tokens = ref.batch_tokens(model, cell.traffic, SEED, 0, "cpu")
    flat = ref.leaves(params)
    mine = {k: v.clone().requires_grad_() for k, v in flat.items()}
    theirs = {k: v.clone().requires_grad_() for k, v in flat.items()}

    def nest(d):
        out: dict = {}
        for name, t in d.items():
            *path, key = name.split(".")
            node = out
            for part in path:
                node = node.setdefault(part, {})
            node[key] = t
        return out

    want = ref.loss(nest(mine), tokens, model)
    got, _ = model_mod.loss_fn(cfg, nest(theirs), {"tokens": tokens})
    assert abs(got.item() - want.item()) <= 1e-6 * abs(want.item())
    g_want = torch.autograd.grad(want, list(mine.values()))
    g_got = torch.autograd.grad(got, list(theirs.values()))
    for name, a, b in zip(mine, g_got, g_want):
        # float32 in another order of operations: the leaf's largest gap
        # over its largest gradient
        err = (a - b).abs().max() / b.abs().max()
        assert err <= 1e-5, (name, float(err))


@pytest.mark.parametrize("bonus", [True, False])
def test_chunked_recurrence_matches_the_loop(bonus):
    """The reference's recurrence in closed form over chunks against its
    definition step by step, values and gradients, in float64 (S = 45: a
    chunk and a part)."""
    gen = torch.Generator().manual_seed(3)
    B, S, H, dh = 2, 45, 3, 8

    def draw(*shape, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=gen, dtype=torch.float64)
                * scale + shift).requires_grad_()

    ins = [draw(B, S, H, dh) for _ in range(3)] \
        + [draw(B, S, H, dh, scale=0.5, shift=-0.6), draw(H, dh)]
    want = ref.wkv_loop(*ins, bonus=bonus)
    got = ref.wkv(*ins, bonus=bonus, chunk=16)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
    dy = torch.randn(want.shape, generator=gen, dtype=torch.float64)
    for a, b in zip(torch.autograd.grad(got, ins, dy, allow_unused=True),
                    torch.autograd.grad(want, ins, dy, allow_unused=True)):
        if b is None:
            assert a is None or not a.any()
        else:
            torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)


def test_train_steps_match_the_reference():
    """The entry's three set-up steps through the port (float32 compute)
    against the reference's: each loss, every leaf's first gradient and
    change, far under the cell's limits."""
    cell = tiny_cell()
    ctx = harness._ctx(cell, SEED, torch.device("cpu"))
    state = entry.setup(ctx)
    unit = entry.step(state, 0)
    assert unit["counts"] == {"tokens": 4 * 16}
    entry.release(state)
    want = entry.reference_unit(state, unit, torch.float32)
    got = unit["first"]
    assert len(got["losses"]) == cell.traffic["first_steps"]
    for a, b in zip(got["losses"], want["losses"]):
        assert abs(a - b) <= 1e-6 * abs(b)
    assert set(got["moments"]) == set(want["moments"])
    for k, m in want["moments"].items():
        err = (got["moments"][k] - m).abs().max() / m.abs().max()
        assert err <= 1e-4, k
    assert set(got["change_norms"]) == set(want["change_norms"])
    for k, n in want["change_norms"].items():
        assert abs(got["change_norms"][k] - n) <= 1e-4 * n, k
    nums = entry.compare(unit, want)
    for k, v in nums.items():
        assert v <= cell.traffic["limits"][k] / 10, k


def test_bfloat16_steps_match_the_reference_at_the_configuration():
    """The port at the configuration's precisions (bfloat16 compute, its
    float32 parts) against the reference in the same precisions: every
    number well inside its limit; against the reference in float32 the
    first gradient reads several times farther off."""
    cell = tiny_cell("bfloat16", batch=8, seq=32)
    ctx = harness._ctx(cell, SEED, torch.device("cpu"))
    state = entry.setup(ctx)
    unit = entry.step(state, 0)
    entry.release(state)
    nums = entry.compare(unit, entry.reference_unit(state, unit,
                                                    torch.float32))
    for k, v in nums.items():
        assert v <= cell.traffic["limits"][k] / 4, (k, v)
    wide = entry.compare(unit, entry._reference(state, mode="float32"))
    assert wide["decay_grad_rel_err"] > 3 * nums["decay_grad_rel_err"]


@pytest.mark.parametrize("trace", [False, True])
def test_round_trip(trace):
    out = harness.run_cell(CELL, SEED, 0.3, trace,
                           t_start=time.perf_counter(), device="cpu",
                           manifest=manifest(), cell=tiny_cell())
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert out["correct"] is True and out["attempted"] >= 1
    assert set(out["checks"]) == set(tiny_cell().traffic["limits"])
    if trace:
        # the CPU has no device trace: the kernels' and the device's
        # metrics read nothing; the step's share of the peak reads
        assert set(out["metrics"]) == {"train_mfu"}
        assert 0 < out["metrics"]["train_mfu"]["value"]
    else:
        assert set(out["metrics"]) == {"train_tokens_per_s", "setup_s"}
        rate = out["metrics"]["train_tokens_per_s"]["value"]
        assert rate > 0 and out["metrics"]["train_tokens_per_s"]["unit"] \
            == "tokens/s"
    json.loads(json.dumps(out))


def _unchanged(real):
    def make(*a, **kw):
        step = real(*a, **kw)
        return lambda state, batch: (state, step(state, batch)[1])
    return make


def _half_batch(real):
    def make(*a, **kw):
        step = real(*a, **kw)

        def run(state, batch):
            tokens = batch["tokens"]
            return step(state, {"tokens": tokens[:len(tokens) // 2]})
        return run
    return make


def _altered_moment(real):
    """The output head's first moment, AdamW's record of its gradient, 10%
    larger than the step made it."""
    def make(*a, **kw):
        step = real(*a, **kw)

        def run(state, batch):
            new, metrics = step(state, batch)
            m = new["opt"]["m"]
            head = dict(m["lm_head"], wlm=m["lm_head"]["wlm"] * 1.1)
            opt = dict(new["opt"], m=dict(m, lm_head=head))
            return dict(new, opt=opt), metrics
        return run
    return make


def _no_dwlog(real):
    """The recurrence's backward (``kernels/wkv6.wkv6_bwd``, under
    ``Wkv6Fn``) returning zeros for wlog's gradient (the fourth of r's, k's,
    v's, wlog's, u's and the initial state's)."""
    from repro_torch.kernels import wkv6 as kw
    bwd = kw.wkv6_bwd

    def broken(*a, **kw_):
        grads = list(bwd(*a, **kw_))
        grads[3] = torch.zeros_like(grads[3])
        return tuple(grads)
    broken.launches = 0
    kw.wkv6_bwd = broken
    return real


@pytest.mark.parametrize("fault", [_unchanged, _half_batch,
                                   _altered_moment, _no_dwlog])
def test_fault_under_the_timed_path_is_not_correct(fault, monkeypatch):
    """The port broken underneath the step that the set-up and the window
    call: a step that returns its state unchanged, half the batch (the mean
    over the rest), an answer of the step altered where it is made, the
    recurrence's backward kernel dropping wlog's gradient."""
    from repro_torch.kernels import wkv6 as kw
    from repro_torch.launch import steps
    monkeypatch.setattr(kw, "wkv6_bwd", kw.wkv6_bwd)
    monkeypatch.setattr(steps, "make_train_step",
                        fault(steps.make_train_step))
    out = harness.run_cell(CELL, SEED, 0.2, False,
                           t_start=time.perf_counter(), device="cpu",
                           manifest=manifest(), cell=tiny_cell())
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


def test_control_and_faults_fail_the_limits():
    """In the program's place, each control of the entry (the reference
    with its weights, or its float32 parts, in bfloat16, its products in
    float8, the bonus u left out) and each fault (half the batch, the
    recurrence's backward without wlog's gradient, the state unchanged)
    fails at least one of the cell's numbers; the port at float32 passes
    every one."""
    cell = tiny_cell(batch=8, seq=32)
    limits = cell.traffic["limits"]
    r = readings(cell, [SEED], device="cpu")
    for k, vals in r["program"].items():
        assert max(vals) <= limits[k], k
    assert set(r["controls"]) == {"bfloat16", "bf16_compute", "fp8",
                                  "no_bonus", "half_batch", "no_dwlog",
                                  "unchanged"}
    for name, nums in r["controls"].items():
        assert any(nums[k][0] > limits[k] for k in limits), name


def test_flop_count_matches_the_work_counter():
    """The yardstick's products by dtype against the port's
    ``counting.WorkCounter`` over one forward and backward (bfloat16
    compute, no recomputation), and its WKV counts against the kernels'
    reported work.  The counter also counts the recurrence's work under
    float32 and, with recomputation on, each layer's forward twice; the
    yardstick counts the model's FLOPs once."""
    from repro_torch.counting import WorkCounter
    from repro_torch.models import model as model_mod
    cell = tiny_cell("bfloat16", batch=2, seq=8)
    cfg = _port_cfg(cell).replace(remat="none")
    model = entry.model_of(cell.config)
    params = ref.init_params(model, SEED, "cpu")
    tokens = ref.batch_tokens(model, cell.traffic, SEED, 0, "cpu")
    flat = ref.leaves(params)
    for t in flat.values():
        t.requires_grad_()
    with WorkCounter(track_memory=False) as counter:
        loss, _ = model_mod.loss_fn(cfg, params, {"tokens": tokens})
        torch.autograd.grad(loss, list(flat.values()))
    B, S = 2, 8
    kernel_flops = sum(k["flops"] for k in counter.kernels.values())
    counted = dict(counter.flops)
    counted["float32"] -= kernel_flops
    assert {k: v for k, v in counted.items() if v} \
        == roof.matmul_flops(model, B, S)
    L = model["n_layers"]
    assert counter.kernels["wkv6"]["calls"] == L
    assert counter.kernels["wkv6"]["flops"] \
        == L * roof.wkv_ops(model, B, S, roof.WKV_OPS)
    assert counter.kernels["wkv6_bwd"]["flops"] \
        == L * roof.wkv_ops(model, B, S, roof.WKV_BWD_OPS)
    assert counter.kernels["wkv6"]["bytes"] \
        == L * roof.wkv6_work(model, B, S)["bytes"]
    assert counter.kernels["wkv6_bwd"]["bytes"] \
        == L * roof.wkv6_bwd_work(model, B, S)["bytes"]
    step = roof.train_step_flops(model, B, S)
    assert step["float32"] == counted["float32"] + kernel_flops
    assert step["bfloat16"] == counted["bfloat16"]


def test_full_size_counts():
    """At the cell's sizes: the step's FLOPs and the kernels' bounds."""
    cell = harness.Cell.load(manifest(), CELL)
    model = entry.model_of(cell.config)
    B, S = cell.traffic["batch"], cell.traffic["seq"]
    flops = roof.train_step_flops(model, B, S)
    assert flops["bfloat16"] == 3 * 4096 * (24 * (8 * 2048**2 + 4 * 2048 * 64
                                                  + 4 * 2048 * 7168)
                                            + 2 * 2048 * 65536)
    assert flops["float32"] == 3 * 4096 * 24 * 2 * 2048**2 + 24 * 8 * 32 \
        * 512 * ((5 + 14) * 64**2 + (8 + 21) * 64)
    assert 0.07 < roof.least_step_seconds(flops) < 0.075
    from divabench.roofline import least_seconds
    assert 4.0e-5 < least_seconds(roof.wkv6_work(model, B, S)) < 4.3e-5
    assert 1.1e-4 < least_seconds(roof.wkv6_bwd_work(model, B, S)) < 1.2e-4


def test_the_reference_loads_nothing_of_the_program():
    code = (f"import sys; sys.path[:0] = [{str(harness.ROOT)!r}, "
            f"{str(harness.ROOT / 'src')!r}]\n"
            "from divabench import reference_rwkv6, roofline_rwkv6\n"
            "import json; print(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env)
    assert res.returncode == 0, res.stderr[-3000:]
    loaded = set(json.loads(res.stdout.strip().splitlines()[-1]))
    assert not loaded & {"jax", "jaxlib", "flax", "repro", "repro_torch"}


def test_manifest_entries():
    """The configuration at its published widths, uncut and equal to the
    port's registry entry; the cell on one chip; the training metric with
    its cells; every per-layer metric of the cell moving it."""
    from repro_torch.configs.registry import get_config
    m = manifest()
    conf = {c["name"]: c for c in m["configs"]}["rwkv6-1.6b"]
    assert conf["reduced"] == []
    cell = harness.Cell.load(m, CELL)
    sizes = cell.config["model"]
    assert (sizes["n_layers"], sizes["d_model"], sizes["rwkv_head_dim"],
            sizes["d_ff"], sizes["vocab_size"], sizes["rwkv_decay_lora"]) \
        == (24, 2048, 64, 7168, 65536, 64)
    port = get_config(cell.config["arch_id"])
    assert all(getattr(port, k) == v for k, v in sizes.items())
    w = {x["name"]: x for x in m["workloads"]}[CELL]
    assert (w["config"], w["traffic"], w["chips"]) == ("rwkv6-1.6b", "train",
                                                       1)
    e2e = {x["name"]: x for x in m["end_to_end"]}
    assert e2e["train_tokens_per_s"]["workloads"] == [CELL]
    mine = [x for x in m["per_layer"] if CELL in x.get("workloads", [])]
    assert {x["name"] for x in mine} == {"train_mfu", "wkv6_roofline",
                                        "wkv6_bwd_roofline",
                                        "idle_frac.train"}
    assert all(x["moves"] == "train_tokens_per_s" for x in mine)
    assert {x["name"] for x in harness.metrics_for(m, "end_to_end", CELL)} \
        == {"train_tokens_per_s", "peak_mem_gb", "setup_s"}

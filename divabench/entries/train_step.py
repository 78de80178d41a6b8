"""Training: one optimizer step of the port's train step a unit.

Set-up makes the run's weights (``reference_rwkv6.init_params``, float32,
on the card from the seed) and hands them to the program as its train state
(``{"params", "opt": AdamW's init, "step"}``, the layout
``launch/train.build_state`` builds), builds the step with
``launch/steps.make_train_step`` and runs the first ``first_steps`` steps
through the window's own call and feed (the first builds the kernels and
lets the tuner pick).  It keeps what the check compares: each step's loss
and global gradient norm, AdamW's first moment of every leaf after step 1
(a host copy) and every leaf's norm of its change over those steps, read
before the window's first step replaces them.  A unit: a
fresh batch of Zipf-frequency tokens from the seed
(``reference_rwkv6.batch_tokens``), one step, the loss read back to the
host.

The check: the plain reference retrains the same first steps from the same
weights and batches at the configuration's precisions
(``reference_rwkv6.train``, mode ``"config"``).  Compared, each side's first
gradient taken from its first moment and its own global norm (before the
clip: the norm follows a few first positions whose group norm is nearly
singular and differs between any two orders of operations, PERF.md): the
output head's (``head_grad_rel_err``, the norm of the difference over the
reference's; it does not pass back through the layers) and the decay
LoRA's and w0's over all layers together, whose gradient the recurrence's
backward computes as wlog's (``decay_grad_rel_err``, the same, and
``decay_grad_norm_gap``, the gap between the two norms over the
reference's); and the median over the leaves of the gap between the norms
of each leaf's change over the first steps, each over the larger of the
reference's norm of that leaf and of its median leaf
(``median_change_gap``; leaves whose reference gradient is under a
thousandth of the median leaf's move by round-off alone and are left
out).
"""
from __future__ import annotations

import math
import statistics

import torch

from divabench import reference_rwkv6 as ref

# a leaf whose reference gradient norm is under this share of the median
# leaf's moves under AdamW by round-off alone
ROUND_OFF_LEAF = 1e-3
HEAD = ("lm_head.wlm",)
# the leaves whose gradient comes from the recurrence's wlog gradient alone
DECAY = ("layers.w0", "layers.wa", "layers.wb")


def model_of(config: dict) -> dict:
    """The sizes and dtypes the reference and the yardstick read."""
    return dict(config["model"], float32_leaves=config["float32_leaves"],
                wkv_dtypes=config["wkv_dtypes"])


def _tokens(state, step: int):
    ctx = state["ctx"]
    return ref.batch_tokens(state["model"], ctx.traffic, ctx.seed, step,
                            ctx.device)


def _run(state, tokens):
    """One step of the program on ``tokens``; its loss, read back, and its
    metrics."""
    state["train"], metrics = state["step_fn"](state["train"],
                                               {"tokens": tokens})
    return float(metrics["loss"]), metrics


def _unclip(gnorm: float, traffic: dict) -> float:
    """The factor from AdamW's first moment after step 1 to the gradient
    before the clip: 1 / ((1 - b1) min(1, clip / the step's norm))."""
    if gnorm == 0:
        return 0.0
    return 1.0 / ((1 - traffic["adamw"]["b1"])
                  * min(1.0, traffic["clip_norm"] / gnorm))


def setup(ctx):
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import steps
    from repro_torch.optim import get_optimizer
    t = ctx.traffic
    cfg = get_config(ctx.config["arch_id"]).replace(**ctx.config["model"])
    model = model_of(ctx.config)
    params = ref.init_params(model, ctx.seed, ctx.device)
    step_fn = steps.make_train_step(
        cfg, base_lr=t["base_lr"], warmup=t["warmup"],
        total_steps=t["total_steps"], clip_norm=t["clip_norm"])
    # the state is held here alone: each step replaces it
    state = dict(ctx=ctx, model=model, step_fn=step_fn, train={
        "params": params, "opt": get_optimizer(cfg.optimizer).init(params),
        "step": torch.zeros((), dtype=torch.int32, device=ctx.device)})
    del params
    first = {"losses": [], "gnorms": [], "tokens": []}
    for i in range(t["first_steps"]):
        tokens = _tokens(state, i)
        first["tokens"].append(tokens.cpu())
        loss, metrics = _run(state, tokens)
        first["losses"].append(loss)
        first["gnorms"].append(float(metrics["gnorm"]))
        if i == 0:
            # the next step replaces this moment
            first["moments"] = {k: v.cpu() for k, v in
                                ref.leaves(state["train"]["opt"]["m"])
                                .items()}
    first["unclip"] = _unclip(first["gnorms"][0], t)
    start = ref.leaves(ref.init_params(model, ctx.seed, ctx.device))
    now = ref.leaves(state["train"]["params"])
    first["change_norms"] = ref.norms(list(start), (now[k] - p0 for k, p0
                                                   in start.items()))
    del start, now
    state["first"] = first
    return state


def step(state, i: int) -> dict:
    t = state["ctx"].traffic
    loss, _ = _run(state, _tokens(state, t["first_steps"] + i))
    return {"i": i, "counts": {"tokens": t["batch"] * t["seq"]},
            "loss": loss, "first": state["first"]}


def release(state) -> None:
    state["train"] = state["step_fn"] = None


def _reference(state, traffic=None, mode: str = "config", **kw) -> dict:
    ctx = state["ctx"]
    traffic = traffic or ctx.traffic
    params = ref.init_params(state["model"], ctx.seed, ctx.device)
    batches = [tok.to(ctx.device) for tok in state["first"]["tokens"]]
    out = ref.train(state["model"], traffic, params, batches, mode=mode,
                    **kw)
    out["unclip"] = _unclip(out["gnorms"][0], traffic)
    return out


def reference_unit(state, unit: dict, dtype) -> dict:
    """The reference's readings of the first steps: at the configuration's
    precisions, or in ``dtype`` bfloat16 all through."""
    return _reference(state, mode="config" if dtype == torch.float32
                      else "bf16_compute")


class _Controls(dict):
    """Controls by name, each run when it is read, so that one at a time
    holds the card."""

    def __getitem__(self, name):
        return super().__getitem__(name)()

    def items(self):
        return ((name, make()) for name, make in super().items())

    def values(self):
        return (make() for make in super().values())


def _unchanged(state) -> dict:
    """A step that returns its state unchanged: the losses of the first
    weights at every step (the reference at a rate of 0), AdamW's first
    moment and the weights unmoved (zeros)."""
    t = state["ctx"].traffic
    still = _reference(state, traffic=dict(t, base_lr=0.0))
    return dict(still, moments={k: torch.zeros((), device=m.device)
                                .expand(m.shape)
                                for k, m in still["moments"].items()},
                change_norms=dict.fromkeys(still["change_norms"], 0.0))


def controls(state, unit: dict) -> dict:
    """The reference in the program's place: its weights and AdamW's state
    in bfloat16 (``bfloat16``); the configuration's float32 parts (r, wlog,
    the recurrence, the norms, the loss) in bfloat16 (``bf16_compute``);
    its bfloat16 products in float8 e4m3 (``fp8``); the bonus u left out of
    the recurrence (``no_bonus``); and faults: the mean over half the batch,
    the recurrence's backward returning no gradient for wlog, a step that
    returns its state unchanged."""
    t = state["ctx"].traffic
    return _Controls({
        "bfloat16": lambda: _reference(state, mode="bfloat16"),
        "bf16_compute": lambda: _reference(state, mode="bf16_compute"),
        "fp8": lambda: _reference(state, mode="fp8"),
        "no_bonus": lambda: _reference(state, bonus=False),
        "half_batch": lambda: _reference(state, rows=t["batch"] // 2),
        "no_dwlog": lambda: _reference(state, dwlog=False),
        "unchanged": lambda: _unchanged(state)})


def _finite(value: float) -> float:
    """``value``; infinite where it is not a number."""
    return math.inf if math.isnan(value) else value


def _gaps(got: dict, want: dict, names, fg: float, fw: float):
    """The norms of ``got``'s and ``want``'s first gradients over
    ``names`` together, and of their difference."""
    sums = torch.zeros(3, dtype=torch.float64)
    with torch.no_grad():
        for k in names:
            w = want[k].float() * fw
            g = got[k].to(w.device).float() * fg
            sums += torch.stack([torch.sum(g * g), torch.sum(w * w),
                                 torch.sum((g - w) ** 2)]).double().cpu()
    return sums.sqrt().tolist()


def compare(unit: dict, ref_out: dict) -> dict:
    """``unit``: a window's unit, which carries the program's readings of
    the first steps, or a control's readings in the program's place."""
    got = unit.get("first", unit)
    want_m = ref_out["moments"]
    if set(got["moments"]) != set(want_m):
        raise KeyError("the program's leaves and the reference's differ")
    fg, fw = got["unclip"], ref_out["unclip"]
    _, head_w, head_d = _gaps(got["moments"], want_m, HEAD, fg, fw)
    dec_g, dec_w, dec_d = _gaps(got["moments"], want_m, DECAY, fg, fw)
    grads = ref.norms(list(want_m), want_m.values())
    g_scale = statistics.median(grads.values())
    moved = [k for k, n in grads.items() if n >= ROUND_OFF_LEAF * g_scale]
    changes = ref_out["change_norms"]
    c_scale = statistics.median(changes.values())
    gaps = [abs(got["change_norms"][k] - changes[k])
            / max(changes[k], c_scale) for k in moved]
    return {"decay_grad_norm_gap": _finite(abs(dec_g - dec_w) / dec_w),
            "decay_grad_rel_err": _finite(dec_d / dec_w),
            "head_grad_rel_err": _finite(head_d / head_w),
            "median_change_gap": _finite(statistics.median(gaps))}


def kernel_work(state) -> dict:
    from divabench.roofline_rwkv6 import (train_step_flops, wkv6_bwd_work,
                                          wkv6_work)
    t, model = state["ctx"].traffic, state["model"]
    B, S = t["batch"], t["seq"]
    return {"wkv6": wkv6_work(model, B, S),
            "wkv6_bwd": wkv6_bwd_work(model, B, S),
            "train_step": train_step_flops(model, B, S)}

"""RWKV-6 training's yardstick: the model FLOPs of a train step by dtype, and
the work of one launch of each ``wkv6`` kernel, counted from the
configuration and the batch's shape, whatever implements the step.

A train step's model FLOPs are its forward and its backward, recomputation
not counted.  Each matrix product ``(T, m) @ (m, n)`` counts ``2 T m n`` in
the forward and twice that in the backward (the input's gradient and the
weight's; every product's input descends from the embedding, which is
trained); it runs in float32 where its weight is one of the configuration's
``float32_leaves`` (``wr``: bfloat16 @ float32 promotes) and in the compute
dtype otherwise.  The WKV recurrence counts its own float32 operations,
forward and backward, as the kernels' work below.  Elementwise operations,
norms, the softmax and the optimizer count none.

Peaks: ``roofline.py``'s (NVIDIA H100 SXM data sheet, dense, 700 W) and the
tensor cores' bfloat16 rate, 989.4 TFLOP/s dense.
"""
from __future__ import annotations

from divabench.roofline import PEAKS, roofline_percent

PEAK_FLOPS = {"bfloat16": 989.4e12, "float32": PEAKS["fp32"]}
DTYPE_BYTES = {"float32": 4, "bfloat16": 2}

# float32 operations of the recurrence per (batch row, head, step): 5 per
# (i, j) of the dh x dh state (r.S: a product and a sum; w*S + k*v: two
# products and a sum) and 8 per i (the decay's negation and two exps; the
# rank-one u term: r*u*k, its sum, v_j times it and the add); the backward
# 14 per (i, j) and 21 per i
WKV_OPS = (5, 8)
WKV_BWD_OPS = (14, 21)
# the kernels' symbols in a device trace: the recurrence, and the backward
# with its sum of du over the batch
SYMBOLS = {"wkv6": ("wkv6_kernel<",),
           "wkv6_bwd": ("wkv6_bwd_kernel<", "wkv6_du_kernel")}


def _products(model: dict) -> list:
    """One layer's products as (weight, fan-in, fan-out), then the head's."""
    D, Fd, R = (model[k] for k in ("d_model", "d_ff", "rwkv_decay_lora"))
    return [("wr", D, D), ("wk", D, D), ("wv", D, D), ("wg", D, D),
            ("wa", D, R), ("wb", R, D), ("wo", D, D), ("wck", D, Fd),
            ("wcv", Fd, D)]


def matmul_flops(model: dict, batch: int, seq: int) -> dict:
    """The step's matrix-product FLOPs by dtype name, forward and
    backward (3 products each)."""
    T, L = batch * seq, model["n_layers"]
    keep = set(model["float32_leaves"])
    low = model["compute_dtype"]
    out: dict = {}
    for w, m, n in _products(model):
        dt = "float32" if w in keep else low
        out[dt] = out.get(dt, 0) + 3 * L * 2 * T * m * n
    out[low] = out.get(low, 0) + 3 * 2 * T * model["d_model"] \
        * model["vocab_size"]
    return out


def _heads(model: dict) -> tuple[int, int]:
    dh = model["rwkv_head_dim"]
    return model["d_model"] // dh, dh


def wkv_ops(model: dict, batch: int, seq: int, ops: tuple) -> int:
    H, dh = _heads(model)
    return batch * H * seq * (ops[0] * dh * dh + ops[1] * dh)


def train_step_flops(model: dict, batch: int, seq: int) -> dict:
    """The step's model FLOPs by dtype: its products, and its recurrence's
    forward and backward in float32, once each."""
    out = matmul_flops(model, batch, seq)
    wkv = model["n_layers"] * (wkv_ops(model, batch, seq, WKV_OPS)
                               + wkv_ops(model, batch, seq, WKV_BWD_OPS))
    out["float32"] = out.get("float32", 0) + wkv
    return out


def least_step_seconds(flops: dict) -> float:
    """The least time of a step's FLOPs, each dtype at its peak."""
    return sum(n / PEAK_FLOPS[dt] for dt, n in flops.items())


def _input_bytes(model: dict, batch: int, seq: int) -> int:
    """r, k, v, wlog (B, S, H, dh) each in its dtype, and u (H, dh)."""
    H, dh = _heads(model)
    n = batch * seq * H * dh
    return sum(n * DTYPE_BYTES[model["wkv_dtypes"][t]]
               for t in ("r", "k", "v", "wlog")) + 4 * H * dh


def wkv6_work(model: dict, batch: int, seq: int) -> dict:
    """One ``wkv6`` launch from a zero state: each input read once, y
    (float32) and the final state (float32) written once."""
    H, dh = _heads(model)
    out_bytes = 4 * batch * seq * H * dh + 4 * batch * H * dh * dh
    return {"ops": wkv_ops(model, batch, seq, WKV_OPS), "peak": "fp32",
            "bytes": _input_bytes(model, batch, seq) + out_bytes}


def wkv6_bwd_work(model: dict, batch: int, seq: int) -> dict:
    """One ``wkv6_bwd`` launch (no start state, no cotangent of the final
    state, as in training): each input and dy (float32) read once, each
    gradient written once in its input's dtype."""
    H, dh = _heads(model)
    dy = 4 * batch * seq * H * dh
    return {"ops": wkv_ops(model, batch, seq, WKV_BWD_OPS), "peak": "fp32",
            "bytes": 2 * _input_bytes(model, batch, seq) + dy}


def kernel_share(run, kernel: str):
    """``kernel``'s share of its roofline in the traced window, in percent:
    its launches' least time over the device time of its symbols; None
    without a trace or a launch."""
    if run.trace is None or kernel not in run.work:
        return None
    first, *rest = SYMBOLS[kernel]
    launches, seconds = run.trace.symbol(first)
    for sym in rest:
        seconds += run.trace.symbol(sym)[1]
    return roofline_percent(run.work[kernel], launches, seconds)

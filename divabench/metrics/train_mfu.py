"""train_mfu: the whole train step's share of the card's peak, in percent —
the least time of a step's model FLOPs (forward and backward, recomputation
not counted, each product at its dtype's peak and the WKV recurrence at the
float32 peak; ``roofline_rwkv6.py`` counts them from the configuration and
the batch's shape) over the window's mean step time (host clock)."""
from divabench.roofline_rwkv6 import least_step_seconds


def read(run):
    flops = run.work.get("train_step")
    if not flops or not run.units:
        return None
    return 100.0 * least_step_seconds(flops) * run.units / run.window_s

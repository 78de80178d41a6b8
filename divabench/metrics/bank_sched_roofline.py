"""bank_sched_roofline: the FR-FCFS walk kernel's (``fast_walk_kernel``)
share of its roofline, in percent: the int32 operations bound (231 a walk
step at a queue of 8) over its device time."""
from divabench.metrics._roofline import share


def read(run):
    return share(run, "bank_sched")

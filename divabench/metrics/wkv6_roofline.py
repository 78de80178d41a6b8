"""wkv6_roofline: the WKV recurrence kernel's (``wkv6_kernel``) share of its
roofline in the traced window, in percent: the least time of its launches'
work (``roofline_rwkv6.py``: 5 float32 operations per (i, j) of the state
and 8 per i, a step and head; the inputs read and y and the state written
once) over their device time.  A train step launches it twice a layer (the
forward and the recomputation)."""
from divabench.roofline_rwkv6 import kernel_share


def read(run):
    return kernel_share(run, "wkv6")

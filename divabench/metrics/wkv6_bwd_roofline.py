"""wkv6_bwd_roofline: the WKV recurrence's backward (``wkv6_bwd_kernel`` and
its sum of du over the batch, ``wkv6_du_kernel``) share of its roofline in
the traced window, in percent: 14 float32 operations per (i, j) and 21 per
i, a step and head (``roofline_rwkv6.py``), over their device time."""
from divabench.roofline_rwkv6 import kernel_share


def read(run):
    return kernel_share(run, "wkv6_bwd")

"""permute_roofline: the burst permutation kernel's (DIVA Shuffling's
``permute_kernel``) share of its roofline, in percent: the bytes bound (576
int32 lanes read and written a burst) over its device time."""
from divabench.metrics._roofline import share


def read(run):
    return share(run, "permute")

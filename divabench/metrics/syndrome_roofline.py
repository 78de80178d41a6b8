"""syndrome_roofline: the SECDED syndrome kernel's share of its roofline, in
percent: the bytes bound (72 int32 bits read, 8 written a codeword) over its
device time."""
from divabench.metrics._roofline import share


def read(run):
    return share(run, "syndrome")

"""fail_prob_roofline: ``fail_prob``'s share of its roofline, in percent:
the bytes bound (4 bytes a cell written) over its device time."""
from divabench.metrics._roofline import share


def read(run):
    return share(run, "fail_prob")

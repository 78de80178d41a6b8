"""fail_prob_roofline.eval: ``fail_prob``'s share of its roofline in
``paper96.evaluate`` (the burst profile's grids, one a data chip), in
percent: the bytes bound (4 bytes a cell written) over its device time."""
from divabench.metrics._roofline import share


def read(run):
    return share(run, "fail_prob")

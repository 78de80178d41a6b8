"""fail_prob_op_roofline: ``fail_prob_op``'s share of its roofline, in
percent, with the voltage shift and the retention channel on: the
operations bound (119 float32 operations a cell) over its device time."""
from divabench.metrics._roofline import share


def read(run):
    return share(run, "fail_prob_op")

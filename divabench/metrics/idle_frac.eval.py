"""idle_frac.eval: the card's idle share of the traced window, in percent, in
the cells that report the matching end-to-end rate."""
from divabench.metrics._idle import idle_percent


def read(run):
    return idle_percent(run)

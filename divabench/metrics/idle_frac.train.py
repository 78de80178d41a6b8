"""idle_frac.train: the card's idle share of the traced window, in percent, in
the cells that report train_tokens_per_s."""
from divabench.metrics._idle import idle_percent


def read(run):
    return idle_percent(run)

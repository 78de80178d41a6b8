"""A kernel's share of its roofline in the traced window: the least time of
its launches' work (``roofline.py``, counted from the shapes) over their
device time by symbol name."""
from divabench.roofline import SYMBOLS, roofline_percent


def share(run, kernel: str):
    if run.trace is None or kernel not in run.work:
        return None
    launches, seconds = run.trace.symbol(SYMBOLS[kernel])
    return roofline_percent(run.work[kernel], launches, seconds)

"""The card's idle share of the traced window, in percent: one minus the
union of its kernels', copies' and fills' intervals over the window."""


def idle_percent(run):
    if run.trace is None or run.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)

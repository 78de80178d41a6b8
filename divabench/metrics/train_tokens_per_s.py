"""train_tokens_per_s: tokens trained a second — every token of the window's
completed optimizer steps over all of the window's time (host clock), each
step's loss read back to the host as a logging training loop does."""


def read(run):
    tokens = run.counts.get("tokens", 0)
    return tokens / run.window_s if tokens else None

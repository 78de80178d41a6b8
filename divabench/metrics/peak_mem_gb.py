"""peak_mem_gb: the card's ``max_memory_allocated`` over the window, reset
at the end of set-up, in GB (1e9 bytes).  A fleet's chunk size is bounded
by it."""


def read(run):
    if not run.peak_window_bytes:
        return None
    return run.peak_window_bytes / 1e9

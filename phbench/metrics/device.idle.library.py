"""Share of the traced window of the library cells in which no operation
ran on the card (the profiler's device timeline, kernels and copies)."""


def read(trace):
    tl = trace.timeline
    if tl is None or tl.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tl.busy_s / tl.window_s)

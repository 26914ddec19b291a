"""The share of the traced window in which no operation ran on the card."""


def read(trace, work):
    if trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)

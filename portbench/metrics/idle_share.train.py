"""Layer: device. The share of the traced steps' window in which no
kernel, copy or memset runs on the card (the union of their intervals),
in %."""


def read(run):
    if run.mode != "train" or run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])

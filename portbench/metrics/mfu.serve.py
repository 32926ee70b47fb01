"""Layer: model forward. The forward's model operations (`flops.py`) times
the window's requests over the window's seconds times the card's bf16 peak,
in %."""
from portbench.flops import PEAK_FLOPS


def read(run):
    if run.mode != "serve":
        return None
    return 100.0 * run.count.fwd * run.requests / (run.window_s * PEAK_FLOPS)

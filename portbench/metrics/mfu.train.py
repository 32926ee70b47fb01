"""Layer: training step. A step's model operations (the forward, the input
gradients above the lowest trained leaf, the trained leaves' weight
gradients; `flops.py`) times the window's steps over the window's seconds
times the card's bf16 peak, in %."""
from portbench.flops import PEAK_FLOPS


def read(run):
    if run.mode != "train":
        return None
    return 100.0 * run.count.step_flops * run.steps / (run.window_s * PEAK_FLOPS)

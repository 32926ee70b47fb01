"""Layer: kernels (`ops/*`, `csrc/*`). The least time of the forward's
products and attention cores, each the larger of its operations over the
bf16 peak and its bytes over the HBM bandwidth (`flops.py`), over the
device-busy time of one traced request, in %."""


def read(run):
    if run.mode != "serve" or run.trace is None or run.trace["busy_s"] <= 0:
        return None
    return 100.0 * run.count.roofline_s / (run.trace["busy_s"] / run.trace["count"])

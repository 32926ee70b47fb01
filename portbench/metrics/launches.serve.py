"""Layer: model forward (`models/*`, `nn/*`). CUDA kernels launched by one
request, from the trace of the traced requests."""


def read(run):
    if run.mode != "serve" or run.trace is None:
        return None
    return run.trace["kernels"] / run.trace["count"]

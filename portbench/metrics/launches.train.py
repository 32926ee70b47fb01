"""Layer: training step (`train/steps.py`, `train/optim.py`,
`ops/fused_attn.py::_Recompute`). CUDA kernels launched by one step, from
the trace of the traced steps."""


def read(run):
    if run.mode != "train" or run.trace is None:
        return None
    return run.trace["kernels"] / run.trace["count"]

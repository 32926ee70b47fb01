"""The 95th percentile of every request's wall in the window, from
`predict` called to the float32 logits returned (host clock)."""
from portbench.harness import percentile


def read(run):
    return percentile(run.latencies_ms, 95) if run.mode == "serve" else None

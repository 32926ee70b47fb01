"""Layer: serving (`serving.py`). Device ms of the host-to-device copies of
one request, from the trace of the traced requests."""


def read(run):
    if run.mode != "serve" or run.trace is None:
        return None
    return run.trace["h2d_s"] * 1e3 / run.trace["count"]

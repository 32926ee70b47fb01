"""Clips of every request completed in the window over the window's
seconds (host clock; the window ends when its last request returns)."""


def read(run):
    return run.clips / run.window_s if run.mode == "serve" else None

"""Clips of every training step completed in the window over the window's
seconds (host clock; the window ends after a synchronize)."""


def read(run):
    return run.clips / run.window_s if run.mode == "train" else None

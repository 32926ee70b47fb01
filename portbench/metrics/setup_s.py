"""Set-up: process start to the first timed request or step (host clock).
Building the kernels, drawing the weights and the traffic, the server's
cast copy, warming every shape of the window, and a training cell's checked
first steps all land here."""


def read(run):
    return run.setup_s

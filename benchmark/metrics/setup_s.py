"""Seconds from the process's start to the window's: building and loading
the kernels, the weights and the traffic, and the warm-up (the check's own
work left out)."""


def read(r):
    return r.setup_s

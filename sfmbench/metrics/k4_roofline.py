"""K4's share of its roofline over the window: the least time of its calls
(counts/k4.py, from each call's shapes and real keys, each route at its
precision's peak) over the device time of K4's kernels in the trace."""


def read(run):
    return run.roofline("k4")

"""K3's share of its roofline over the window: the least time of its calls
(counts/k3.py, from the int_covs calls' shapes, at float32's peak) over the
device time of K3's kernel in the trace."""


def read(run):
    return run.roofline("k3")

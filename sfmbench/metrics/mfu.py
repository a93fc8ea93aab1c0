"""The whole window's share of the chip's peak: the least time of the
window's counted work (every forward of each net from its published shapes,
and the kernels' counted operations; the configuration's `counted` list,
each at its precision's peak) over the window's wall."""


def read(run):
    least = run.counted_least_s()
    return 100.0 * least / run.window_s if least else None

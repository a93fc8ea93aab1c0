"""The share of the traced window in which no operation runs on the device
(the union of the trace's kernel, copy and set intervals)."""


def read(run):
    return 100.0 * (1.0 - run.device.busy_s / run.device.window_s) if run.device.window_s > 0 else None

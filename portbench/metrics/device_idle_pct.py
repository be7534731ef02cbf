"""``device_idle_pct``: the share of the traced window in which no
operation ran on the device, in %."""

from ._kernels import Reading


def read(r: Reading):
    if r.trace_window_s <= 0 or r.busy_s <= 0:
        return None
    return 100.0 * (1.0 - r.busy_s / r.trace_window_s)

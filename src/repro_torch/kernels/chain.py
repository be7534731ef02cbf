"""The depth of the port scans' dependency graph (``csrc/port_scan.cuh``).

Event k of a timeline reads ``in[src[k]]`` and ``out[dst[k]]``, which the
last earlier admitted event with the same source (the same destination)
wrote, and writes both where it is admitted.  So event k waits for those
two events only, and no schedule over the graph runs in fewer dependent
steps than its longest chain: its depth L, counted in events.
``chip_smoke.py`` multiplies L by the measured latency of one step for the
crossbar scan's and the netsim replay's chain bound.
"""

from __future__ import annotations

import numpy as np

__all__ = ["chain_depth"]


def chain_depth(src, dst, admit=None) -> int:
    """L of the timeline ``src``/``dst`` [m]: every event admitted (the
    ungated forms), or per row of ``admit`` [B, m] (the gated forms; a
    refused event reads the ports but writes neither), the largest over
    rows."""
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    m = src.size
    if m == 0:
        return 0
    n = int(max(src.max(), dst.max())) + 1
    if admit is None:
        din, dout, depth = [0] * n, [0] * n, 0
        for i, j in zip(src.tolist(), dst.tolist()):
            d = 1 + max(din[i], dout[j])
            din[i] = dout[j] = d
            depth = max(depth, d)
        return depth
    admit = np.asarray(admit, bool).reshape(-1, m)
    din = np.zeros((admit.shape[0], n), np.int64)
    dout = np.zeros_like(din)
    depth = np.zeros(admit.shape[0], np.int64)
    for k, (i, j) in enumerate(zip(src.tolist(), dst.tolist())):
        d = 1 + np.maximum(din[:, i], dout[:, j])
        np.maximum(depth, d, out=depth)
        a = admit[:, k]
        din[:, i] = np.where(a, d, din[:, i])
        dout[:, j] = np.where(a, d, dout[:, j])
    return int(depth.max())

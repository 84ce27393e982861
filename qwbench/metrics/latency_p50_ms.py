"""The median latency of the traced run, of every request due in the
window timed from when it was due, where the card sits idle more than
half of the window, so that the host alone paces it."""

import numpy as np


def read(run):
    if not run.latencies_ms or run.busy_s >= 0.5 * run.window_s:
        return None
    return float(np.percentile(run.latencies_ms, 50))

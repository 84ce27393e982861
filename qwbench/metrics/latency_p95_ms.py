"""The 95th percentile latency of the traced run, where the card sits
idle more than half of the window, so that the host alone paces the
tail."""

import numpy as np


def read(run):
    if not run.latencies_ms or run.busy_s >= 0.5 * run.window_s:
        return None
    return float(np.percentile(run.latencies_ms, 95))

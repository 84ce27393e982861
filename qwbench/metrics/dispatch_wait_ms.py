"""The executor, the dispatching thread off the CPU: per completed
request, the query profile's `execute` phases whose stage starts with
`dispatch`, their wall ms less their thread CPU ms (the time the thread
waited for the GIL, a lock or other requests' threads), averaged over
the window's completed requests."""

from qwbench.metrics.dispatch_cpu_ms import (is_dispatch, mean_per_request,
                                             phases)


def _wait_ms(profile):
    timed = [p["duration_ms"] - p["cpu_ms"] for p in phases(profile)
             if is_dispatch(p) and "cpu_ms" in p]
    return sum(timed), bool(timed)


def read(run):
    return mean_per_request(run, _wait_ms)

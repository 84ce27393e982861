"""Service routing: the device programs a request's splits launched, by
the query profile's `device_dispatches` counter (a dispatch shared by
several requests counts once for each), averaged over the window's
completed requests."""

from qwbench.metrics.dispatch_cpu_ms import mean_per_request

_COUNTER = "device_dispatches"


def _dispatches(profile):
    own = profile.get("counters", {})
    total, found = own.get(_COUNTER, 0.0), _COUNTER in own
    for child in profile.get("leaves", ()):
        value, carried = _dispatches(child)
        total, found = total + value, found or carried
    return total, found


def read(run):
    return mean_per_request(run, _dispatches)

"""The executor, the host blocked on the device->host copy: per completed
request, the wall ms of the query profile's `execute` phases of stage
`readback`, averaged over the window's completed requests."""

from qwbench.metrics.dispatch_cpu_ms import mean_per_request, phases


def _readback_ms(profile):
    timed = [p["duration_ms"] for p in phases(profile)
             if p.get("name") == "execute" and p.get("stage") == "readback"]
    return sum(timed), bool(timed)


def read(run):
    return mean_per_request(run, _readback_ms)

"""The load generator and the root's admission: per completed request, ms
from when it was due to when the root created its query profile (the
profile's `origin_s`, on the generator's `time.perf_counter` clock),
averaged over the window's completed requests that carry an origin."""


def read(run):
    lags = [(o.response.profile["origin_s"] - o.due) * 1e3
            for o in run.done
            if o.response.profile and "origin_s" in o.response.profile]
    if not lags:
        return None
    return sum(lags) / len(lags)

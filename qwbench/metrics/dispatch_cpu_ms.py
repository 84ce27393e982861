"""The executor, the host enqueuing device programs (`search/executor.py`,
`parallel/fanout.py`): per completed request, the recording thread's CPU
ms over the query profile's `execute` phases whose stage starts with
`dispatch`, averaged over the window's completed requests. The helpers
here serve the other readers of the profile's execute phases."""


def phases(profile: dict):
    """Every phase of a profile and of its remote leaves' profiles."""
    yield from profile.get("phases", ())
    for child in profile.get("leaves", ()):
        yield from phases(child)


def is_dispatch(phase: dict) -> bool:
    return (phase.get("name") == "execute"
            and str(phase.get("stage", "")).startswith("dispatch"))


def mean_per_request(run, read_profile):
    """The mean over the completed requests of `read_profile(profile)`,
    which returns (value, whether the profile carried what it reads);
    None where no request's profile carried it."""
    values, carried = [], False
    for o in run.done:
        value, found = read_profile(o.response.profile or {})
        values.append(value)
        carried = carried or found
    if not carried:
        return None
    return sum(values) / len(values)


def _cpu_ms(profile):
    timed = [p["cpu_ms"] for p in phases(profile)
             if is_dispatch(p) and "cpu_ms" in p]
    return sum(timed), bool(timed)


def read(run):
    return mean_per_request(run, _cpu_ms)

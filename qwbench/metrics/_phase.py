"""Shared by the phase readers: a query profile phase's milliseconds,
summed per request and averaged over the window's completed requests."""


def mean_phase_ms(run, phase: str):
    values = run.phases.get(phase)
    if not values:
        return None
    return sum(values) / len(values)

"""Lowering (`search/plan.py`, reached through `search/root.py`): the
query profile's `plan_build` phase, ms per request."""

from qwbench.metrics._phase import mean_phase_ms


def read(run):
    return mean_phase_ms(run, "plan_build")

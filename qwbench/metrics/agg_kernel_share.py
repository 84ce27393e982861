"""The aggregations (`ops/aggs.py`, `ops/kernels/aggs.py`): of the
aggregation nodes the window's split programs evaluated, the share the
one-pass aggregation kernel computed, in %, by the query profile's
`agg_evals` and `agg_kernel_evals` counters summed over the completed
requests and their leaves. None where no profile carries them (a program
without the kernel)."""

_EVALS = "agg_evals"
_KERNEL = "agg_kernel_evals"


def _sums(profile):
    own = profile.get("counters", {})
    evals, kernel = own.get(_EVALS, 0.0), own.get(_KERNEL, 0.0)
    for child in profile.get("leaves", ()):
        child_evals, child_kernel = _sums(child)
        evals, kernel = evals + child_evals, kernel + child_kernel
    return evals, kernel


def read(run):
    evals = kernel = 0.0
    for o in run.done:
        e, k = _sums(o.response.profile or {})
        evals, kernel = evals + e, kernel + k
    if evals <= 0:
        return None
    return 100.0 * kernel / evals

"""Search (`search/executor.py`, `ops/kernels/score_topk.py`): of the
split programs that selected hits in the window, the share whose top-k
the fused CUDA kernel (`score_topk` or `score_topk_lanes`) computed, in
%, by the query profile's `topk_evals` and `topk_kernel_evals` counters
summed over the completed requests and their leaves. None where no
profile carries them (a program that does not count them)."""

_EVALS = "topk_evals"
_KERNEL = "topk_kernel_evals"


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

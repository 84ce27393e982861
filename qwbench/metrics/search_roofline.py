"""Search (`search/executor.py`, `ops/kernels/score_topk.py`), by the
work the requests need: the postings of each request's query terms, and
where it asks for hits the timestamp lanes its time bounds select and
the sort column over the docs it matches (`roofline.search_bytes`), at
the card's HBM rate, over the device's busy time in the traced window,
in %. None where no request reads postings or asks for hits."""

from qwbench.roofline import share


def read(run):
    needed = [n["search"] for n in run.needed if "search" in n]
    if not needed:
        return None
    return share(sum(needed), run.busy_s)

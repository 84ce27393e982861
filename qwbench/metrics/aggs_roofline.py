"""The aggregations (`ops/aggs.py`), by the work the requests need: the
columns each aggregation-only request reads over the docs its time range
selects, at their stored widths (`roofline.aggregation_bytes`), at the
card's HBM rate, over the device's busy time in the traced window, in %.
Read only where every request is aggregation-only and reads no
postings."""

from qwbench.roofline import share


def read(run):
    if not run.needed or any("aggs" not in n or "search" in n
                             for n in run.needed):
        return None
    return share(sum(n["aggs"] for n in run.needed), run.busy_s)

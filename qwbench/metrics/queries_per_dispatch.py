"""The batcher (`search/batcher.py`): queries that entered it over the
device dispatches it issued in the window, by its
`qw_search_batcher_queries_total` and `qw_search_batcher_dispatches_total`
counters."""


def read(run):
    dispatches = run.counters["batcher_dispatches"]
    if dispatches <= 0:
        return None
    return run.counters["batcher_queries"] / dispatches

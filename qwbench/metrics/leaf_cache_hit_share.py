"""The service's leaf-response cache (Tier C, `search/cache.py` under
`search/service.py`): hits over lookups in the window, in %, by its
`qw_leaf_cache_hits_total` and `qw_leaf_cache_misses_total` counters."""


def read(run):
    hits = run.counters["leaf_cache_hits"]
    lookups = hits + run.counters["leaf_cache_misses"]
    if lookups <= 0:
        return None
    return 100.0 * hits / lookups

"""Per-layer metric ``chem.cache_hit_rate.serve`` (%): the chemistry
cache's hits over its lookups (hits, misses and relabel misses) in the
window. Returns None where the run has nothing for it to read."""


def read(ctx):
    c = ctx["counters"]
    if not c.get("cache_lookups"):
        return None
    return 100.0 * c["cache_hits"] / c["cache_lookups"]

"""Per-layer metric ``chem.host_ms_per_step.serve`` (ms): host milliseconds
of candidate enumeration and fingerprints (``engine.chem_stats()``
enum_s + fp_s) per service step over the window. Returns None where the
run has nothing for it to read."""


def read(ctx):
    c = ctx["counters"]
    if not c.get("service_steps"):
        return None
    return 1e3 * c["chem_s"] / c["service_steps"]

"""Per-layer metric ``serving.step_ms.serve`` (ms): wall milliseconds per
service step over the window (``stats()['n_service_steps']``). Returns
None where the run has nothing for it to read."""


def read(ctx):
    c = ctx["counters"]
    if not c.get("service_steps"):
        return None
    return 1e3 * c["window_s"] / c["service_steps"]

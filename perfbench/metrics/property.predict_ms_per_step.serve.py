"""Per-layer metric ``property.predict_ms_per_step.serve`` (ms): host
milliseconds in the property tier (the benchmark's span around the
``ResilientService.predict`` it built) per service step. Returns None
where the run has nothing for it to read."""


def read(ctx):
    c = ctx["counters"]
    s = c.get("span_s", {}).get("property")
    if s is None or not c.get("service_steps"):
        return None
    return 1e3 * s / c["service_steps"]

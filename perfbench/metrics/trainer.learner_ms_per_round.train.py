"""Per-layer metric ``trainer.learner_ms_per_round.train`` (ms): host
milliseconds in ``run_updates`` (the benchmark's span) per learner round
(one update of every worker) over the window. Returns None where the run
has nothing for it to read."""


def read(ctx):
    c = ctx["counters"]
    s = c.get("span_s", {}).get("learner")
    if s is None or not c.get("rounds"):
        return None
    return 1e3 * s / c["rounds"]

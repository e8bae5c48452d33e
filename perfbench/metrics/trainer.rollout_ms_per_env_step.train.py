"""Per-layer metric ``trainer.rollout_ms_per_env_step.train`` (ms): host
milliseconds of the trainer's rollout (the benchmark's span around
``rollout_episode``: enumeration, fingerprints, the fleet Q dispatch,
selection, the property batch, rewards and replay writes) per fleet env
step over the window. Returns None where the run has nothing for it to
read."""


def read(ctx):
    c = ctx["counters"]
    s = c.get("span_s", {}).get("rollout")
    if s is None or not c.get("env_steps"):
        return None
    return 1e3 * s / c["env_steps"]

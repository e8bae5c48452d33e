"""Per-layer metric ``qdispatch.ms.train`` (ms): milliseconds per fleet Q
dispatch of the host-to-device copy and the ``packed_qnet_stacked``
kernel, by the trainer's CUDA events (``dispatch_timing()``), over the
window's dispatches. Returns None where the run has nothing for it to
read."""


def read(ctx):
    c = ctx["counters"]
    if not c.get("dispatches"):
        return None
    return c["dispatch_ms"] / c["dispatches"]

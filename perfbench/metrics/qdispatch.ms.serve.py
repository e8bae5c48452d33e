"""Per-layer metric ``qdispatch.ms.serve`` (ms): milliseconds per Q
dispatch of the host-to-device copy and the ``fused_qnet`` kernel, by
the service's CUDA events (``dispatch_timing()``), over the window's
dispatches. Returns None where the run has nothing for it to read."""


def read(ctx):
    c = ctx["counters"]
    if not c.get("dispatches"):
        return None
    return c["dispatch_ms"] / c["dispatches"]

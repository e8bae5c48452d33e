"""Per-layer metric ``packed_qnet_roofline`` (%): the least time the traced
fleet Q dispatches could take (per dispatch, the larger of its real
rows' FLOPs at the f32 peak and every worker's weights once plus its
real rows' packed input and f32 output at HBM bandwidth:
``harness.work.packed_dispatch_bound_s``) over the device time of the
Q-network kernels (names with ``qnet::``) in the trace. Returns None
where the run has nothing for it to read."""


def read(ctx):
    c, tr = ctx["counters"], ctx["trace"]
    if not tr or not c.get("trace_q_bound_s"):
        return None
    kernel_s = sum(s for n, s in tr["device_s_by_name"].items() if "qnet::" in n)
    if kernel_s <= 0:
        return None
    return 100.0 * c["trace_q_bound_s"] / kernel_s

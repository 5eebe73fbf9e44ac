"""Device ms a step of the expert products on the grouped entry of
``csrc/matmul.cu`` (``grouped_matmul``, all three layouts: the forward, its
recompute, and the backward's dX and dW); None where the trace has no such
kernel."""

KERNELS = ("grouped_matmul<",)


def read(r):
    if r.trace is None or not r.counters.get("steps"):
        return None
    t = r.trace.kernel_s(KERNELS)
    if t <= 0:
        return None
    return 1e3 * t / r.counters["steps"]

"""Device milliseconds a train step in kernels of the elementwise class
(the profiler's kernel names containing "elementwise": the plain
attention's float32 softmax, the casts, AdamW's arithmetic), over the
traced steps."""


KERNEL = r"elementwise"


def read(records):
    trace = records.get("trace")
    if trace is None or "traced_steps" not in records:
        return None
    seconds, launches = trace.kernel(KERNEL)
    if not launches:
        return None
    return 1e3 * seconds / records["traced_steps"]

"""Kernel B6's share of its roofline in the traced window: its bound (the
algorithm's operations and bytes at the cell's shape, bench/roofline.py)
times its launches over its device seconds, in %."""


# B6 on either path of csrc/deepgrid_fwd.cu
KERNEL = r"deepgrid_(?:reg|general)_kernel"


def read(records):
    trace = records.get("trace")
    if trace is None or "b6_bound_s" not in records:
        return None
    seconds, launches = trace.kernel(KERNEL)
    if not launches:
        return None
    return 100.0 * records["b6_bound_s"] * launches / seconds

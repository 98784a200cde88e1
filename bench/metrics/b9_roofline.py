"""Kernel B9's share of its roofline over one traced cycle of the mix: the
bounds of its launches (the algorithm's operations and bytes at each
prompt length, bench/roofline.py) over their device seconds, in %."""


# B9 on either path of csrc/flash_attn_fwd.cu
KERNEL = r"flash_fwd_(?:bf16|f32)_kernel"


def read(records):
    trace = records.get("trace")
    if trace is None or "b9_bound_s" not in records:
        return None
    seconds, launches = trace.kernel(KERNEL)
    if not launches:
        return None
    return 100.0 * records["b9_bound_s"] / seconds

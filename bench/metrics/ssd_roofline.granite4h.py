"""The SSD scan's share of its roofline over one traced cycle of the mix:
the bound of every mamba layer's scan (bench/granite_counts.py: x, B, C,
dt read and y written once, or the chunked dual form's flops at the bf16
peak, whichever is larger) over the device seconds of the ops launched
inside the program's ``ssm.scan`` spans in the spans pass, in %."""

from bench import spans


def read(records):
    if "ssd_bound_s" not in records:
        return None
    table = spans.table(records)
    if table is None or not table.calls.get("ssm.scan"):
        return None
    return 100.0 * records["ssd_bound_s"] / (1e-3 * table.device_ms(
        "ssm.scan"))

"""Share of the spans pass's device busy time in the ops launched inside
the program's ``lm.cache`` spans (the KV cache made zero-filled, and each
layer's keys and values written into it), in %; bench/spans.py."""

from bench import spans


def read(records):
    table = spans.table(records)
    if table is None or not table.calls.get("lm.prefill"):
        return None
    return table.busy_pct("lm.cache")

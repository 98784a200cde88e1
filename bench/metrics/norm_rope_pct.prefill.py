"""Share of the spans pass's device busy time in the ops launched inside
the program's ``lm.norm`` or ``attn.rope`` spans (RMSNorm and RoPE, both
computed in float32), in %; bench/spans.py."""

from bench import spans


def read(records):
    table = spans.table(records)
    if table is None or not table.calls.get("lm.prefill"):
        return None
    return table.busy_pct("lm.norm", "attn.rope")

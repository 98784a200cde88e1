"""Share of the spans pass's device busy time in the ops launched inside
the program's ``lm.moe`` spans but not their ``moe.shared`` (the router,
the dispatch, the held experts' grouped matmuls and the combine), in %;
bench/spans.py."""

from bench import spans


def read(records):
    table = spans.table(records)
    if table is None or not table.calls.get("lm.moe"):
        return None
    return table.busy_pct("lm.moe") - table.busy_pct("moe.shared")

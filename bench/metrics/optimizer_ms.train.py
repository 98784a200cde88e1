"""Device milliseconds a train step in the ops launched inside the
program's ``train.optimizer`` span (AdamW's update: the clipping norm, the
moments and the new params), over the spans pass's steps (its
``train.step`` spans); bench/spans.py."""

from bench import spans


def read(records):
    table = spans.table(records)
    if table is None or not table.calls.get("train.step"):
        return None
    return table.device_ms("train.optimizer") / table.calls["train.step"]

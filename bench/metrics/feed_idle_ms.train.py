"""Device idle milliseconds a train step while the main thread is inside
the program's ``data.batch`` span (the token stream making a batch on the
host), over the spans pass's steps (its ``train.step`` spans);
bench/spans.py."""

from bench import spans


def read(records):
    table = spans.table(records)
    if table is None or not table.calls.get("train.step"):
        return None
    return table.idle_ms("data.batch") / table.calls["train.step"]

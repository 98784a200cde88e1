"""Trained tokens a second: every token of the window's steps over the
window's seconds (host clock, to the last step's end)."""


def read(records):
    if "tokens" not in records or "steps" not in records:
        return None
    return records["tokens"] / records["window_s"]

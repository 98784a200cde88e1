"""Prompt tokens prefilled a second: every prompt token of the window's
finished batches over the window's seconds (host clock)."""


def read(records):
    if "prompt_tokens" not in records:
        return None
    return records["prompt_tokens"] / records["window_s"]

"""The device's allocated peak over the training window
(``torch.cuda.max_memory_allocated`` after a reset at the window's start),
in GiB."""


def read(records):
    peak = records.get("window_peak_bytes")
    if not peak:
        return None
    return peak / 2**30

"""Share of the traced window in which no operation ran on the device, in
%."""


def read(records):
    trace = records.get("trace")
    if trace is None:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)

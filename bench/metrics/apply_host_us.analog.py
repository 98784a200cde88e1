"""Host microseconds an apply takes to enqueue: the benchmark's span
around each ``CompiledDeepProgram.apply`` call of the window, without a
synchronize, averaged."""


def read(records):
    if "apply_host_s" not in records:
        return None
    return records["apply_host_s"] * 1e6

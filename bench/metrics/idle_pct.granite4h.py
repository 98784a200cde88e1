"""Share of the traced window of the Granite 4.0 hybrid prefill in which
no operation ran on the device, in %: ``idle_pct.prefill``'s reading."""

from bench import harness


def read(records):
    return harness.read_metric("idle_pct.prefill", records)

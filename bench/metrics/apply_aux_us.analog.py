"""Device microseconds an apply in the ops launched inside the program's
``analog.prep`` or ``analog.readout`` spans (the input's padding, cast and
column gather; the row gather and the slice around kernel B6), over the
spans pass's applies (its ``analog.apply`` spans); bench/spans.py."""

from bench import spans


def read(records):
    table = spans.table(records)
    if table is None or not table.calls.get("analog.apply"):
        return None
    return (1e3 * table.device_ms("analog.prep", "analog.readout")
            / table.calls["analog.apply"])

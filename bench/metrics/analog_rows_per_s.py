"""Input rows through the compiled analog processor a second: every row of
the window over the window's seconds (host clock, to the last apply's
end)."""


def read(records):
    if "rows" not in records:
        return None
    return records["rows"] / records["window_s"]

"""The process's peak of allocated device memory by the window's end
(set-up runs the same step), in GB."""


def read(records):
    peak = records.get("train_peak_bytes")
    return peak / 1e9 if peak else None

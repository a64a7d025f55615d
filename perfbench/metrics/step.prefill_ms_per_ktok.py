"""The engine's prefill flushes in the window: their time per thousand
prompt tokens, in ms (its own samples)."""


def read(records):
    p = records["prefill"]
    return 1e6 * sum(p["seconds"]) / p["tokens"] if p["tokens"] else None

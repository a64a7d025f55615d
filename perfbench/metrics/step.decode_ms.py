"""Mean time of the engine's decode step in the window (its own host-clock
samples, each ending in the sampled tokens' read), in ms."""


def read(records):
    d = records["ticks"]["decode_s"]
    return 1e3 * sum(d) / len(d) if d else None

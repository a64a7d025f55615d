"""Mean number of lanes decoding at each engine tick of the window (the
engine's own occupancy samples)."""


def read(records):
    occ = records["ticks"]["occupancy"]
    return sum(occ) / len(occ) if occ else None

"""Share of the traced span of the training window with no kernel running."""
from perfbench.yardstick import idle_share


def read(records):
    return idle_share(records["trace"])

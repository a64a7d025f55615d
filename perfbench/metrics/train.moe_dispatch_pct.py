"""The MoE dispatch's device time (``moe.dispatch`` spans, the forward's and
remat's recompute's) over the traced span's busy time, in percent."""
from perfbench import program_spans


def read(records):
    return program_spans.device_share(records, lambda name: name == "moe.dispatch")

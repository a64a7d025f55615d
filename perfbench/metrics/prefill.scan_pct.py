"""The Mamba2 scans' device time (``mamba.scan.*`` spans, either route)
over the traced span's busy time, in percent."""
from perfbench import program_spans


def read(records):
    return program_spans.device_share(records, lambda name: name.startswith("mamba.scan."))

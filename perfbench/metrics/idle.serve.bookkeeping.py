"""Share of the traced span of the serving window in which no kernel runs
while the engine's host is inside a tick (``engine.tick``) but neither
launching a step nor waiting for one: admission, page growth, handing
tokens to sessions."""
from perfbench import program_spans


def read(records):
    return program_spans.idle_within(records, ("engine.tick",), program_spans.LAUNCH_OR_WAIT)

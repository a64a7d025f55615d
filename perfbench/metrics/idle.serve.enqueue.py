"""Share of the traced span of the serving window in which no kernel runs
while the engine's host is launching a step (in ``engine.decode.enqueue``
or ``engine.prefill.enqueue``)."""
from perfbench import program_spans


def read(records):
    return program_spans.idle_within(records, program_spans.ENQUEUE)

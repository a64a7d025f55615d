"""The prompt tokens the engine's prefill fed over the lane-token slots its
chunk steps computed (``engine.prefill_fed`` / ``engine.prefill_slots``) in
the traced span, in percent."""
from perfbench import program_spans


def read(records):
    return program_spans.counter_share("engine.prefill_fed", "engine.prefill_slots")

"""The KV positions live at the engine's decode steps over the positions
those steps gathered (``engine.kv_live`` / ``engine.kv_gathered``) in the
traced span, in percent."""
from perfbench import program_spans


def read(records):
    return program_spans.counter_share("engine.kv_live", "engine.kv_gathered")

"""The device time of the train step's clipping and AdamW update
(``train.clip`` and ``train.optimizer`` spans) over the traced span's busy
time, in percent."""
from perfbench import program_spans


def read(records):
    return program_spans.device_share(records,
                                      lambda name: name in ("train.clip", "train.optimizer"))

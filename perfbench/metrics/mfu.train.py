"""Model FLOPs of every training step of the window (forward and backward,
remat's recompute not counted) over the window, as a share of the card's
bf16 peak."""
from perfbench import yardstick


def read(records):
    if not records["steps"]:
        return None
    tokens = records["steps"] * records["batch"] * records["seq"]
    flops = yardstick.train_flops(records["model"], tokens, records["seq"])
    return 100.0 * flops / (records["window_s"] * yardstick.PEAK_BF16_FLOPS)

"""Model FLOPs of every prefill call of the window over the window (its
start to the end of its last call), as a share of the card's bf16 peak."""
from perfbench import yardstick


def read(records):
    if not records["calls"]:
        return None
    flops = records["calls"] * yardstick.zamba2_forward_flops(
        records["model"], records["batch"], records["seq"])
    return 100.0 * flops / (records["window_s"] * yardstick.PEAK_BF16_FLOPS)

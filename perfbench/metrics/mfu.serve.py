"""Model FLOPs the window served (each prompt prefilled in it, each later
token decoded in it at its context) over the window, as a share of the
card's bf16 peak."""
from perfbench import yardstick


def read(records):
    m = records["model"]
    w0, w1 = records["window"]
    flops = 0.0
    for r in records["requests"]:
        times = r["times"]
        if times and w0 <= times[0] < w1:
            flops += yardstick.moe_lm_forward_flops(m, r["prompt_len"], r["prompt_len"])
        for i, t in enumerate(times[1:], start=1):
            if w0 <= t < w1:
                flops += yardstick.moe_decode_flops(m, r["prompt_len"] + i - 1)
    if not flops:
        return None
    return 100.0 * flops / ((w1 - w0) * yardstick.PEAK_BF16_FLOPS)

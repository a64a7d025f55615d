"""The flash-attention kernel's share of its roofline in the traced span:
the sum over its launches of the least time the card could take at the
call's shapes (causal pairs only, each input read once and the output
written once) over the sum of the kernel's device time."""
from perfbench import yardstick


def read(records):
    trace = records["trace"]
    events = [e for e in trace.get("device_events", []) if yardstick.is_flash_kernel(e[0])]
    if not events:
        return None
    m = records["model"]
    b, s = records["batch"], records["seq"]
    bound = yardstick.roofline_seconds(
        yardstick.flash_flops(b, s, m["n_heads"], m["head_dim"]),
        yardstick.flash_bytes(b, s, m["n_heads"], m["n_kv_heads"], m["head_dim"]))
    spent = sum(end - start for _, start, end in events)
    return 100.0 * bound * len(events) / spent

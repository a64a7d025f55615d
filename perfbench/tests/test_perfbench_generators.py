"""The traffic generator repeats under a seed, differs across seeds, and
gives every seed the same sizes."""
import json

import numpy as np

from perfbench import traffic
from perfbench.tests import tiny  # noqa: F401  (puts the repository on the path)

CHAT = {"block": 64, "pairing_seed": 5,
        "prompt_tokens": {"dist": "log_normal", "median": 724, "sigma": 0.6},
        "output_tokens": {"dist": "log_normal", "median": 90, "sigma": 0.6, "min": 32}}


def _requests(seed, n=130):
    stream = traffic.RequestStream(CHAT, seed, 50304)
    return [next(stream) for _ in range(n)]


def test_requests_repeat_under_a_seed():
    a, b = _requests(2**31 + 17), _requests(2**31 + 17)
    assert [(r.prompt, r.max_new_tokens) for r in a] == [(r.prompt, r.max_new_tokens) for r in b]


def test_requests_differ_across_seeds_in_ids_alone():
    a, b = _requests(1), _requests(2)
    assert [r.prompt for r in a] != [r.prompt for r in b]
    assert [(len(r.prompt), r.max_new_tokens) for r in a] == [
        (len(r.prompt), r.max_new_tokens) for r in b]
    assert [len(r.prompt) for r in a[:64]] != [len(r.prompt) for r in a[64:128]]


def test_every_block_holds_the_same_sizes():
    for seed in (1, 2, 3):
        reqs = _requests(seed, 128)
        for block in (reqs[:64], reqs[64:]):
            got = sorted((len(r.prompt), r.max_new_tokens) for r in block)
            assert got == sorted(traffic.request_sizes(CHAT))


def test_sizes_are_the_log_normal_grid():
    """A block's sizes are the midpoints of 64 equal-probability bins:
    symmetric about the median in log space, clipped where the file says."""
    sizes = traffic.request_sizes(CHAT)
    prompts = sorted(p for p, _ in sizes)
    outs = [o for _, o in sizes]
    assert abs(np.median(prompts) - 724) <= 1
    assert abs(np.log(prompts[0] / 724) + np.log(prompts[-1] / 724)) < 0.01
    assert abs(np.log(prompts[-1] / 724) - 0.6 * 2.418) < 0.01  # z of the top bin's midpoint
    assert min(outs) == 32


def test_an_unknown_size_distribution_is_refused():
    import pytest

    with pytest.raises(ValueError, match="unknown size distribution"):
        traffic.size_grid({"dist": "log_uniform", "lo": 1, "hi": 9}, 4)


def test_the_chat_sizes_sit_about_the_published_medians():
    """The serving cell's mix: log-normal about the trace's medians (1020
    prompt and 129 output tokens), every request within the context."""
    chat = json.loads((tiny.ROOT / "perfbench/traffic/chat.json").read_text())
    sizes = traffic.request_sizes(chat)
    prompts = [p for p, _ in sizes]
    outs = [o for _, o in sizes]
    assert np.median(prompts) == 1020 and abs(np.median(outs) - 129) <= 5
    assert max(p + o for p, o in sizes) <= chat["max_len"]
    assert min(prompts) < 400 and max(prompts) > 3000 and min(outs) < 20 and max(outs) > 1000


def test_a_cut_keeps_prompt_and_output_within_max_len():
    t = {**CHAT, "max_len": 1024, "prompt_tokens": {"dist": "log_normal", "median": 700,
                                                     "sigma": 0.5, "max": 1023}}
    sizes = traffic.request_sizes(t)
    assert max(p for p, _ in sizes) == 1023 and max(p + o for p, o in sizes) == 1024
    assert min(o for _, o in sizes) >= 1


def test_prompt_batches_are_fresh_each_call_and_repeat():
    t = {"batch": 2, "seq": 64}
    a0, a1 = traffic.prompt_batch(t, 9, 0, 32000), traffic.prompt_batch(t, 9, 1, 32000)
    assert a0.shape == (2, 64) and a0.dtype == np.int32
    assert not np.array_equal(a0, a1)
    assert np.array_equal(a0, traffic.prompt_batch(t, 9, 0, 32000))
    assert not np.array_equal(a0, traffic.prompt_batch(t, 10, 0, 32000))


def test_train_batches_repeat_and_rows_differ():
    t = {"batch": 2, "seq": 128}
    a = traffic.train_batch(t, 3, 0, 50304)
    assert np.array_equal(a["tokens"], traffic.train_batch(t, 3, 0, 50304)["tokens"])
    assert not np.array_equal(a["tokens"], traffic.train_batch(t, 3, 1, 50304)["tokens"])
    assert not np.array_equal(a["tokens"][0], a["tokens"][1])
    assert a["tokens"].min() >= 0 and a["tokens"].max() < 50304


def test_train_batches_equal_the_programs_stream():
    from repro_torch.data.synth import SyntheticLM

    prog = SyntheticLM(50304, 128, 2, seed=3).batch_at(4)
    mine = traffic.train_batch({"batch": 2, "seq": 128}, 3, 4, 50304)
    assert np.array_equal(prog["tokens"], mine["tokens"])
    assert np.array_equal(prog["targets"], mine["targets"])

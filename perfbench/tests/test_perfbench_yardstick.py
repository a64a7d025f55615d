"""The yardstick's arithmetic against hand-worked values."""
import math

import pytest

from perfbench import yardstick


def test_p95_is_the_nearest_rank_over_all_values():
    assert yardstick.p95(list(range(1, 21))) == 19  # ceil(0.95 * 20) = 19
    assert yardstick.p95(list(range(40, 0, -1))) == 38
    assert yardstick.p95([]) == math.inf


def test_rate_is_all_the_work_over_all_the_window():
    assert yardstick.rate(300, 30.0) == 10.0
    with pytest.raises(ValueError):
        yardstick.rate(1, 0)


def test_busy_union_and_idle_gaps_on_a_synthetic_trace():
    spans = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.2, 3.5), (6.0, 7.0)]
    assert yardstick.busy_seconds(spans) == pytest.approx(4.0)
    assert yardstick.idle_gaps(spans, 0.0, 7.0) == [(2.0, 3.0), (4.0, 6.0)]
    assert yardstick.idle_share({"window_s": 8.0, "busy_s": 4.0, "device_events": [1]}) == 50.0
    assert yardstick.idle_share({}) is None


def test_flash_counts():
    # one sequence of 4, one head of 2: 10 causal pairs x 2 matmuls x 2 FLOPs x hd 2
    assert yardstick.flash_flops(1, 4, 1, 2) == 80
    assert yardstick.flash_flops(1, 4, 1, 2, causal=False) == 128
    # q and o: 2 x 4 x 2 values; k and v: 2 x 4 x 2; 2 bytes each
    assert yardstick.flash_bytes(1, 4, 1, 1, 2) == 64
    b, s, h, hd = 2, 4096, 32, 112
    flops = yardstick.flash_flops(b, s, h, hd)
    assert flops == 4 * b * h * hd * s * (s + 1) / 2
    bound = yardstick.roofline_seconds(flops, yardstick.flash_bytes(b, s, h, h, hd))
    assert bound == pytest.approx(flops / 989e12)


MOE = {"d_model": 4, "n_heads": 2, "n_kv_heads": 1, "head_dim": 2, "d_ff": 3, "n_experts": 4,
       "experts_per_token": 2, "n_layers": 1, "vocab_size": 10}


def test_moe_flops_by_hand():
    # per token: projections 4*2*(2*2 + 2*1) = 48, experts 2*3*4*3 = 72, router 16,
    # head 40 -> 176 weights, 2 FLOPs each; attention over 3 pairs of a 2-token
    # sequence: 4 * 2 heads * 2 * 3 = 48
    assert yardstick.moe_lm_forward_flops(MOE, 2, 2) == 2 * 2 * 176 + 48
    assert yardstick.train_flops(MOE, 2, 2) == 3 * (2 * 2 * 176 + 48)
    # one token at context 5: 2 * 176 + 4 * 2 * 2 * 6
    assert yardstick.moe_decode_flops(MOE, 5) == 2 * 176 + 96


def test_zamba2_flops_by_hand():
    m = {"d_model": 2, "ssm_state": 1, "ssm_head_dim": 2, "ssm_expand": 2, "ssm_chunk": 2,
         "ssm_conv_width": 2, "n_layers": 1, "n_heads": 1, "n_kv_heads": 1, "head_dim": 2,
         "d_ff": 3, "mlp_variant": "gelu", "shared_attn_calls": 1, "vocab_size": 5}
    # d_in 4, 2 heads; in 2*(8+2+2)=24, out 8, conv 6*2=12 -> 2*44 = 88 a token;
    # ssd: 2*1 + 2*(2*2 + 4*1*2) = 26; 2 tokens
    mamba = (88 + 26) * 2
    # shared: proj 2*2*2*3 + 2*2 = 28, mlp 2*2*3 = 12 -> 2*40*2 tokens; 3 pairs * 4 * 2
    shared = 2 * 40 * 2 + 4 * 1 * 2 * 3
    assert yardstick.zamba2_forward_flops(m, 1, 2) == mamba + shared + 2 * 2 * 5


def test_flash_kernel_names():
    assert yardstick.is_flash_kernel("void tma_kernel<__nv_bfloat16, 128, 7, 14, 64>(...)")
    assert not yardstick.is_flash_kernel("void ssd_out_kernel<64>(...)")
    assert not yardstick.is_flash_kernel("ampere_bf16_s16816gemm_bf16_128x128")


def test_the_trace_counts_kernels_not_the_harness_annotations():
    """A harness span shows on the device's timeline as an annotation over
    the whole call; busy time is the kernels' union alone."""
    from types import SimpleNamespace

    import torch

    from perfbench.harness import Tracer

    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    def ev(name, a, b, dev):
        return SimpleNamespace(name=name, device_type=dev,
                               time_range=SimpleNamespace(start=a * 1e6, end=b * 1e6))

    events = [ev("perfbench.engine.step", 0.0, 10.0, cpu),
              ev("perfbench.engine.step", 0.0, 10.0, cuda),
              ev("gemm", 1.0, 3.0, cuda), ev("softmax", 2.0, 4.0, cuda),
              ev("copy", 6.0, 7.0, cuda)]
    tracer = Tracer(torch, True, cuda=True)
    tracer.prof = SimpleNamespace(events=lambda: events)
    tracer.t0, tracer.t1 = 0.0, 10.0
    rec = tracer.records()
    assert rec["busy_s"] == pytest.approx(4.0)
    assert [n for n, _ in rec["device_ops"]] == ["gemm", "softmax", "copy"]
    assert rec["idle_gaps"] == [("engine.step", pytest.approx(2.0))]
    assert yardstick.idle_share(rec) == pytest.approx(60.0)

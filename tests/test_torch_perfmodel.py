"""The port's perfmodel against the reference's on the CPU: the roofline of
the same costs over every part of the spec database, and the cost counter
(``extract_costs`` over a callable, ATen FLOPs and bytes) against XLA's
``cost_analysis()`` of the same function, jitted."""
import dataclasses
import importlib

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import hw as jhw
from repro.models import transformer as jtr
from repro.perfmodel import costs as jcosts
from repro.perfmodel import hlo as jhlo
from repro_torch import configs as tconfigs
from repro_torch import hw as thw
from repro_torch.models import transformer as ttr
from repro_torch.models.convert import params_from_jax
from repro_torch.perfmodel import costs as tcosts
from repro_torch.perfmodel import hlo as thlo

# the packages export their roofline function under the module's name
jroof = importlib.import_module("repro.perfmodel.roofline")
troof = importlib.import_module("repro_torch.perfmodel.roofline")
COSTS = dict(flops_per_device=3.2e15, bytes_per_device=4.1e12, transcendentals=2.0e9,
             arg_bytes=5 << 30, out_bytes=1 << 30, temp_bytes=3 << 30, alias_bytes=1 << 29,
             code_bytes=1 << 20)


def _both(coll_bytes):
    j = (jcosts.CompiledCosts(**COSTS), jhlo.CollectiveStats(per_device_bytes=coll_bytes))
    t = (tcosts.CompiledCosts(**COSTS), thlo.CollectiveStats(per_device_bytes=coll_bytes))
    return j, t


def test_the_spec_databases_hold_the_same_parts():
    assert thw.names() == jhw.names()


@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "int8"])
@pytest.mark.parametrize("kind,chips,coll", [("infer", 1, 0.0), ("train", 8, 3.0e10)])
@pytest.mark.parametrize("part", sorted(jhw.names()))
def test_roofline_terms_equal_the_references(part, kind, chips, coll, dtype):
    (jc, jx), (tc, tx) = _both(coll)
    want = jroof.roofline(jc, jx, chips, kind, 2.5e9, 4000, hw=part, dtype=dtype)
    got = troof.roofline(tc, tx, chips, kind, 2.5e9, 4000, hw=part, dtype=dtype)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.summary() == want.summary()
    if coll == 0.0:
        assert got.collective_s == 0.0


def test_roofline_across_and_the_cost_record_equal_the_references():
    (jc, jx), (tc, tx) = _both(1.0e9)
    want = jroof.roofline_across(jc, jx, 4, "train", 7e9, 1 << 20)
    got = troof.roofline_across(tc, tx, 4, "train", 7e9, 1 << 20)
    assert list(got) == list(want)
    assert [dataclasses.asdict(v) for v in got.values()] == [
        dataclasses.asdict(v) for v in want.values()]
    assert tc.summary() == jc.summary() and tc.peak_hbm_bytes == jc.peak_hbm_bytes
    assert tx.summary() == jx.summary()
    assert troof.model_flops("train", 3e9, 10) == jroof.model_flops("train", 3e9, 10)


def test_counter_equals_xla_on_one_matmul():
    """(64, 128) @ (128, 32) fp32: 2 m k n = 524,288 FLOPs and the three
    arrays' 57,344 bytes in both; no transcendental, the same argument and
    result bytes."""
    rng = np.random.default_rng(0)
    a, b = rng.normal(size=(64, 128)).astype(np.float32), rng.normal(size=(128, 32)).astype(
        np.float32)
    want = jcosts.extract_costs(jax.jit(lambda x, y: x @ y).lower(a, b).compile())
    got = tcosts.extract_costs(lambda x, y: x @ y, torch.from_numpy(a), torch.from_numpy(b))
    fields = ("flops_per_device", "bytes_per_device", "transcendentals", "arg_bytes",
              "out_bytes")
    assert [getattr(got, f) for f in fields] == [getattr(want, f) for f in fields]
    assert (got.flops_per_device, got.bytes_per_device) == (524288.0, 57344.0)


def _gemma(n_layers):
    jcfg = jconfigs.get_config("gemma-2b").reduced().replace(attn_impl="blockwise",
                                                             n_layers=n_layers)
    tcfg = tconfigs.get_config("gemma-2b").reduced().replace(attn_impl="blockwise",
                                                             n_layers=n_layers)
    jp = jax.tree.map(np.asarray, jtr.lm_init(jax.random.PRNGKey(0), jcfg))
    toks = np.random.default_rng(3).integers(0, jcfg.vocab_size, (2, 64)).astype(np.int32)
    want = jcosts.extract_costs(
        jax.jit(lambda p, t: jtr.lm_forward(p, t, jcfg)).lower(jp, toks).compile())
    tp = params_from_jax(jp, tcfg, device="cpu")
    got = tcosts.extract_costs(lambda p, t: ttr.lm_forward(p, t, tcfg), tp,
                               torch.from_numpy(toks))
    return want, got


def test_counter_against_xla_on_the_gemma_forward():
    """gemma-2b reduced, the plain (blockwise) forward, 2 x 64 tokens, cut to
    one layer: XLA's cost_analysis counts a while loop's body once, and the
    reference scans its layers, so past one layer it stops growing (the
    port's count grows by the same per-layer amount each layer).  FLOPs
    within 10 %: XLA adds one an element for the elementwise ops and counts
    the blockwise attention's key loop once; the counter counts only the
    matmuls, every step.  Bytes between 1x and 3x XLA's: XLA reads and
    writes a fused elementwise chain once, eager PyTorch each op of it."""
    want, got = _gemma(1)
    assert abs(got.flops_per_device / want.flops_per_device - 1) < 0.1
    assert 1.0 <= got.bytes_per_device / want.bytes_per_device <= 3.0
    assert (got.arg_bytes, got.temp_bytes) == (want.arg_bytes, 0)
    want2, got2 = _gemma(2)
    _, got3 = _gemma(3)
    per_layer = got2.flops_per_device - got.flops_per_device
    assert per_layer > 0 and got3.flops_per_device - got2.flops_per_device == per_layer
    assert abs(want2.flops_per_device / want.flops_per_device - 1) < 0.01

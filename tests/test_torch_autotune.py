"""The port's ``core.tuning`` and ``core.autotune`` against the reference's:
every ``choose_*`` (and the time model they score with) gives the reference's
value for every part of the spec database over a grid of shapes; the tuning
cache round-trips through its JSON file; and ``kernel_policy(autotune=True)``
resolves the reference's tiles for the same arguments."""
import dataclasses
import json
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.hw as jhw
import repro_torch.hw as thw
from repro.core import autotune as jauto
from repro.core import tuning as jtuning
from repro.kernels import api as japi
from repro_torch.core import autotune as tauto
from repro_torch.core import tuning as ttuning
from repro_torch.kernels import api as tapi

PARTS = jhw.names()
FLOAT_DTYPES = ("float32", "bfloat16", "float16", "int8", "float8_e4m3fn")


def _fields(tile_choice) -> tuple:
    return dataclasses.astuple(tile_choice)


def test_the_port_has_the_references_parts():
    assert thw.names() == PARTS


@pytest.mark.parametrize("hw", PARTS)
@pytest.mark.parametrize("dtype", FLOAT_DTYPES)
def test_choose_matmul_tiles_matches(hw, dtype):
    for m, k, n in ((256, 256, 256), (1024, 512, 2048), (384, 1280, 640), (96, 96, 96),
                    (4096, 4096, 4096), (8192, 1024, 128)):
        assert _fields(tauto.choose_matmul_tiles(m, k, n, dtype, hw=hw)) == \
            _fields(jauto.choose_matmul_tiles(m, k, n, dtype, hw=hw))
        assert tauto.matmul_time_model(m, k, n, 128, 256, 512, dtype, hw) == \
            jauto.matmul_time_model(m, k, n, 128, 256, 512, dtype, hw)
    assert tauto.peak_for(hw, dtype) == jauto.peak_for(hw, dtype)


@pytest.mark.parametrize("hw", PARTS)
@pytest.mark.parametrize("dtype", ("float32", "bfloat16", "int8"))
def test_choose_attention_and_ssm_chunk_match(hw, dtype):
    for seq in (100, 512, 1000, 4096, 32768):
        for hd, heads in ((64, 8), (112, 32), (256, 1), (320, 4)):
            assert tauto.choose_attention_chunk(seq, hd, heads, dtype, hw=hw) == \
                jauto.choose_attention_chunk(seq, hd, heads, dtype, hw=hw)
        for p, n in ((64, 64), (128, 16), (192, 256)):
            assert tauto.choose_ssm_chunk(seq, p, n, dtype, hw=hw) == \
                jauto.choose_ssm_chunk(seq, p, n, dtype, hw=hw)


def test_defaults_are_the_references_part():
    assert tauto.choose_ssm_chunk(1024, 64, 64) == jauto.choose_ssm_chunk(1024, 64, 64) == 512
    assert _fields(tauto.choose_matmul_tiles(2048, 2048, 2048)) == \
        _fields(jauto.choose_matmul_tiles(2048, 2048, 2048))
    assert tauto.dtype_name(torch.bfloat16) == jauto.dtype_name(jnp.dtype(jnp.bfloat16)) == "bfloat16"
    assert tauto.dtype_name(torch.float8_e4m3fn) == "float8_e4m3fn"


def test_tuning_cache_round_trips(tmp_path):
    path = tmp_path / "cache.json"
    cache = ttuning.TuningCache(path=str(path))
    args = (torch.zeros((128, 256)), torch.zeros((256, 64), dtype=torch.bfloat16))
    key = ttuning.make_key("matmul", args, "cuda")
    assert key == "matmul|cuda|float32[128,256];bfloat16[256,64]"
    assert cache.lookup(key) is None and cache.misses == 1
    cache.store(key, {"bm": 128, "bk": np.int64(256), "bn": 64})
    doc = json.loads(path.read_text())
    assert doc == {"version": 1, "entries": {key: {"bm": 128, "bk": 256, "bn": 64}}}
    again = ttuning.TuningCache(path=str(path))
    assert again.lookup(key) == {"bm": 128, "bk": 256, "bn": 64} and again.hits == 1
    # a second process's entries merge in on save; ours win on a conflict
    other = ttuning.TuningCache(path=str(path))
    other.store("ssm_scan|cuda|x", {"chunk": 512})
    cache.store(key, {"bm": 256, "bk": 256, "bn": 64})
    merged = ttuning.TuningCache(path=str(path))
    assert merged.lookup("ssm_scan|cuda|x") == {"chunk": 512}
    assert merged.lookup(key)["bm"] == 256
    assert ttuning.ENV_VAR == "REPRO_TORCH_TUNING_CACHE" != jtuning.ENV_VAR


@pytest.fixture
def fresh_caches():
    ttuning.configure()
    jtuning.configure()
    yield
    ttuning.configure()
    jtuning.configure()


def _reference_tiles(op, args, **kw):
    with japi.kernel_policy(autotune=True):
        fn = japi.get_op(op).bound(*args, backend="interpret", **kw)
    return {k: v for k, v in fn.keywords.items() if k in japi.get_op(op).tile_args}


@pytest.mark.parametrize("case", ["matmul", "matmul_small", "flash_attention", "ssm_scan"])
def test_autotune_policy_resolves_the_references_tiles(case, fresh_caches):
    rng = np.random.default_rng(0)
    args = {
        "matmul": [rng.normal(size=(1024, 512)), rng.normal(size=(512, 2048))],
        "matmul_small": [rng.normal(size=(96, 40)), rng.normal(size=(40, 72))],
        "flash_attention": [rng.normal(size=(1, 1000, 8, 64))] * 3,
        "ssm_scan": [rng.normal(size=(1, 1000, 2, 64)), rng.normal(size=(1, 1000, 2)),
                     rng.normal(size=(1, 1000, 64)), rng.normal(size=(1, 1000, 64))],
    }[case]
    args = [a.astype(np.float32) for a in args]
    op = case.removesuffix("_small")
    want = _reference_tiles(op, [jnp.asarray(a) for a in args])
    targs = tuple(torch.from_numpy(a) for a in args)
    with tapi.kernel_policy(autotune=True):
        got = tapi.get_op(op).resolve_tiles(targs)
        assert got == want and got
        # an explicit kwarg and policy.tiles both win over autotune
        one = tapi.get_op(op).tile_args[0]
        assert tapi.get_op(op).resolve_tiles(targs, {one: 7})[one] == 7
        with tapi.kernel_policy(tiles={op: {one: 9}}):
            assert tapi.get_op(op).resolve_tiles(targs)[one] == 9
    assert ttuning.get_cache().misses == 1 and len(ttuning.get_cache()) == 1
    with tapi.kernel_policy(autotune=True):  # the second resolution is a cache hit
        assert tapi.get_op(op).resolve_tiles(targs) == want
    assert ttuning.get_cache().hits >= 1
    assert tapi.get_op(op).resolve_tiles(targs) == {}  # autotune off: nothing added


def test_autotuners_cost_the_h100_for_tensors_on_the_card():
    """The same shapes on a CUDA device are tiled for the H100."""
    def fake(shape, dtype=torch.bfloat16):
        return types.SimpleNamespace(shape=shape, dtype=dtype, device=torch.device("cuda", 0))

    got = tapi._matmul_autotuner((fake((2048, 2048)), fake((2048, 2048))))
    tc = tauto.choose_matmul_tiles(2048, 2048, 2048, "bfloat16", hw="nvidia-h100-sxm")
    assert got == {"bm": tc.bm, "bk": tc.bk, "bn": tc.bn}
    u, b = fake((4, 1000, 112, 64)), fake((4, 1000, 64))
    assert tapi._ssm_autotuner((u, None, b, b)) == {
        "chunk": tauto.choose_ssm_chunk(1000, 64, 64, "bfloat16", hw="nvidia-h100-sxm")} == \
        {"chunk": 512}
    q = fake((4, 1000, 32, 112))
    assert tapi._attention_autotuner((q, q)) == {
        "bq": 128, "bk": tauto.choose_attention_chunk(1000, 112, 32, "bfloat16",
                                                      hw="nvidia-h100-sxm")}

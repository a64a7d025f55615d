"""The port's distribution layer against the reference's.

**Spec parity.**  For every config of ``CONFIGS`` at full size, on the
(2, 4), (2, 2, 2), (16, 16) and (2, 16, 16) meshes, the port's
``param_specs``, ``zero1_state_specs``, ``cache_shardings``,
``paged_cache_shardings``, ``batch_shardings`` and ``logits_sharding`` equal
the reference's leaf for leaf.  The port's side runs here on abstract meshes
(shape and axis names, no process group) over ``meta`` tensors; the
reference's in one ``tests/utils.py::run_with_devices`` subprocess with 512
fake devices, which prints its specs as JSON.

**Compression and GPipe** run on 2 gloo CPU ranks (``dist.run_ranks``):
``quantize_int8`` is bit for bit the reference's; ``psum_compressed`` over a
2-rank ``pod`` axis equals the reference's ``shard_map`` over ``pod`` bit for
bit (two terms add exactly in either order); ``gpipe_apply``'s output equals
the reference's and the sequential stages', and its gradients equal the
sequential autograd gradients (within 1e-5: the same operations, summed in
another order by the ring's backward).
"""
import json
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.dist.compress import dequantize_int8 as jdequantize
from repro.dist.compress import quantize_int8 as jquantize
from repro_torch.configs import CONFIGS
from repro_torch.dist import (batch_shardings, cache_shardings, dequantize_int8,
                              logits_sharding, paged_cache_shardings, param_specs,
                              quantize_int8, run_ranks, zero1_state_specs)
from repro_torch.dist.sharding import _axis_size, _resolve, tree_map_with_path
from repro_torch.launch.mesh import Mesh, make_mesh_for, make_production_mesh, make_test_mesh
from repro_torch.models import build_model
from repro_torch.optim import AdamW
from repro_torch.train.step import state_shapes
from utils import run_with_devices

import torch_dist_workers as workers

MESHES = {"2x4": ((2, 4), ("data", "model")), "2x2x2": ((2, 2, 2), ("pod", "data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
CACHE = (32, 64)  # batch, max_len
POOL = (64, 16)  # pages, page size
BATCHES = (32, 3)  # global batches: one every dp size divides, one none does
SEQ = 128

_REFERENCE = """
import json
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.configs import CONFIGS
from repro.dist.sharding import (batch_shardings, cache_shardings, logits_sharding,
                                 paged_cache_shardings, param_specs)
from repro.dist.zero import zero1_state_specs
from repro.models import build_model

MESHES = %s
CACHE, POOL, BATCHES, SEQ = %s, %s, %s, %s
devs = np.array(jax.devices())

def spec(s):
    return [list(a) if isinstance(a, tuple) else a for a in s.spec]

def flat(tree):
    out = {}
    for path, s in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out["/".join(str(getattr(p, "key", p)) for p in path)] = spec(s)
    return out

res = {}
for name, cfg in CONFIGS.items():
    model = build_model(cfg)
    shapes = jax.eval_shape(lambda: model.init(jax.random.key(0)))
    cache = jax.eval_shape(lambda: model.init_cache(*CACHE))
    pool = (jax.eval_shape(lambda: model.init_paged_cache(*POOL))
            if model.init_paged_cache is not None else None)
    for mname, (shape, axes) in MESHES.items():
        mesh = Mesh(devs[:int(np.prod(shape))].reshape(shape), axes)
        ps = param_specs(shapes, cfg, mesh)
        batches = {str(b): flat(batch_shardings(
            {"tokens": jax.ShapeDtypeStruct((b, SEQ), jnp.int32),
             "targets": jax.ShapeDtypeStruct((b, SEQ), jnp.int32)}, mesh)) for b in BATCHES}
        res[f"{name}@{mname}"] = {
            "params": flat(ps), "zero": flat(zero1_state_specs(shapes, ps, mesh)),
            "cache": flat(cache_shardings(cache, cfg, mesh)),
            "paged": None if pool is None else flat(paged_cache_shardings(pool, cfg, mesh)),
            "batch": batches,
            "logits": {str(b): spec(logits_sharding(b, cfg.vocab_size, mesh)) for b in BATCHES},
        }
print("JSON" + json.dumps(res))
"""


def _spec(s):
    return [list(a) if isinstance(a, tuple) else a for a in s.spec]


def _flat(tree):
    out = {}
    tree_map_with_path(lambda path, s: out.__setitem__(path, _spec(s)), tree)
    return out


@lru_cache(maxsize=None)
def _reference_specs():
    code = _REFERENCE % (repr(MESHES), repr(CACHE), repr(POOL), repr(BATCHES), SEQ)
    out = run_with_devices(code, n_devices=512, timeout=600)
    return json.loads(out[out.index("JSON") + 4:])


@lru_cache(maxsize=None)
def _port_shapes(name):
    cfg = CONFIGS[name]
    model = build_model(cfg, device="cpu")
    pool = model.paged_cache_specs(*POOL) if model.paged_cache_specs is not None else None
    return state_shapes(model.init, AdamW()).params, model.cache_specs(*CACHE), pool


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_specs_equal_the_reference(name):
    ref = _reference_specs()
    cfg = CONFIGS[name]
    shapes, cache, pool = _port_shapes(name)
    for mname, (shape, axes) in MESHES.items():
        mesh = Mesh(shape, axes)
        want = ref[f"{name}@{mname}"]
        ps = param_specs(shapes, cfg, mesh)
        assert _flat(ps) == want["params"], mname
        assert _flat(zero1_state_specs(shapes, ps, mesh)) == want["zero"], mname
        assert _flat(cache_shardings(cache, cfg, mesh)) == want["cache"], mname
        got_pool = None if pool is None else _flat(paged_cache_shardings(pool, cfg, mesh))
        assert got_pool == want["paged"], mname
        for b in BATCHES:
            batch = {k: torch.empty((b, SEQ), dtype=torch.int32, device="meta")
                     for k in ("tokens", "targets")}
            assert _flat(batch_shardings(batch, mesh)) == want["batch"][str(b)], (mname, b)
            assert _spec(logits_sharding(b, cfg.vocab_size, mesh)) == want["logits"][str(b)]


def test_meshes_and_axis_rules():
    assert make_production_mesh().shape == {"data": 16, "model": 16}
    assert make_production_mesh(multi_pod=True).shape == {"pod": 2, "data": 16, "model": 16}
    assert make_test_mesh().shape == {"data": 2, "model": 4}
    assert make_test_mesh(multi_pod=True).shape == {"pod": 2, "data": 2, "model": 2}
    assert make_mesh_for(8, 2, pods=2).shape == {"pod": 2, "data": 2, "model": 2}
    assert make_mesh_for(4, 2).shape == {"data": 2, "model": 2}
    with pytest.raises(AssertionError):
        make_mesh_for(6, 4)
    mesh = make_test_mesh(multi_pod=True)
    assert _resolve(mesh, "dp") == ("pod", "data") and _resolve(mesh, "tp") == "model"
    assert _axis_size(mesh, ("pod", "data")) == 4 and _axis_size(mesh, None) == 1
    with pytest.raises(ValueError, match="unknown logical axis"):
        _resolve(mesh, "xx")
    # rank r sits at the row-major coordinates of r, as jax.make_mesh lays devices
    assert mesh.coords(5) == {"pod": 1, "data": 0, "model": 1}
    assert mesh.line(5, "data") == [5, 7]
    with pytest.raises(RuntimeError, match="abstract"):
        mesh.index("data")


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_quantize_int8_is_bit_exact(dtype):
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(257,)) * 3).astype(np.float32)
    x[:5] = [127.0, 0.5, -0.5, 1.5, 2.5]  # scale 1: ties, rounded half to even in both
    jx = jnp.asarray(x, dtype)
    jq, js = jquantize(jx)
    tx = torch.from_numpy(np.asarray(jx.astype(jnp.float32))).to(
        torch.bfloat16 if dtype is jnp.bfloat16 else torch.float32)
    q, s = quantize_int8(tx)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js)
    np.testing.assert_array_equal(dequantize_int8(q, s).numpy(), np.asarray(jdequantize(jq, js)))
    zq, zs = quantize_int8(torch.zeros(8))  # a zero tensor stays zero
    assert float(zs) == float(np.float32(1e-30)) and not zq.any()


def test_psum_compressed_matches_the_reference_shard_map():
    x = np.random.default_rng(0).normal(size=(64,)).astype(np.float32)
    out = run_with_devices(
        """
        import jax, jax.numpy as jnp, numpy as np
        from jax.sharding import Mesh, PartitionSpec as P
        from repro.dist.compress import psum_compressed
        x = jnp.asarray(np.random.default_rng(0).normal(size=(64,)).astype(np.float32))
        mesh = Mesh(np.array(jax.devices()[:2]), ("pod",))
        f = jax.shard_map(lambda v: psum_compressed(v, "pod", mode="int8"), mesh=mesh,
                          in_specs=P("pod"), out_specs=P("pod"))
        print("OUT" + ",".join(repr(float(v)) for v in np.asarray(f(jnp.stack([x, 2 * x]))[0])))
        """, n_devices=2)
    want = np.array([float(v) for v in out[out.index("OUT") + 3:].strip().split(",")],
                    np.float32)
    r0, r1 = run_ranks(workers.compress, 2, x, device="cpu", timeout=120)
    np.testing.assert_array_equal(r0["int8"], want)
    np.testing.assert_array_equal(r1["int8"], want)
    np.testing.assert_array_equal(r0["none"], 3 * x)
    err = float(np.abs(r0["int8"] - 3 * x).max() / np.abs(3 * x).max())
    assert err < 0.02, err


def test_psum_compressed_refuses_an_unknown_mode():
    from repro_torch.dist import psum_compressed

    with pytest.raises(ValueError, match="unknown compression mode"):
        psum_compressed(torch.ones(2), "pod", "fp4", mesh=Mesh((1,), ("pod",)))


def test_gpipe_matches_the_reference_and_the_sequential_stages():
    n_stages, n_micro, mb, d = 2, 4, 3, 8
    rng = np.random.default_rng(0)
    w = (rng.normal(size=(n_stages, d, d)) * 0.3).astype(np.float32)
    x = rng.normal(size=(n_micro, mb, d)).astype(np.float32)
    out = run_with_devices(
        """
        import jax, jax.numpy as jnp, numpy as np
        from jax.sharding import Mesh
        from repro.dist.pipeline import gpipe_apply
        rng = np.random.default_rng(0)
        w = jnp.asarray((rng.normal(size=(2, 8, 8)) * 0.3).astype(np.float32))
        x = jnp.asarray(rng.normal(size=(4, 3, 8)).astype(np.float32))
        mesh = Mesh(np.array(jax.devices()[:2]), ("pod",))
        y = gpipe_apply(lambda p, h: jnp.tanh(h @ p["w"]), {"w": w}, x, mesh, axis="pod")
        print("OUT" + ",".join(repr(float(v)) for v in np.asarray(y).ravel()))
        """, n_devices=2)
    ref = np.array([float(v) for v in out[out.index("OUT") + 3:].strip().split(",")],
                   np.float32).reshape(n_micro, mb, d)
    tw = torch.from_numpy(w).requires_grad_(True)
    seq = torch.from_numpy(x)
    for s in range(n_stages):
        seq = torch.tanh(seq @ tw[s])
    (seq ** 2).sum().backward()
    for r in run_ranks(workers.gpipe, 2, w, x, device="cpu", timeout=120):
        np.testing.assert_allclose(r["y"], ref, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(r["y"], seq.detach().numpy(), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(r["grad"], tw.grad.numpy(), rtol=1e-5, atol=1e-5)
        assert r["error"] is not None and "stage dim" in r["error"]


def test_run_ranks_returns_in_rank_order_and_fails_with_a_rank():
    from repro_torch.dist import choose_backend

    assert (run_ranks(workers.world, 3, device="cpu", timeout=120)
            == [(r, 3, "gloo") for r in range(3)])
    assert choose_backend(["cpu", "cpu"]) == "gloo"
    assert choose_backend(["cuda:0", "cuda:1"]) == "nccl"
    assert choose_backend(["cuda", "cuda"]) == choose_backend(["cuda:0", "cpu"]) == "gloo"
    with pytest.raises(RuntimeError, match="rank 1 failed(.|\\n)*on purpose"):
        run_ranks(workers.fail_on_one, 2, device="cpu", timeout=120)
    with pytest.raises(TimeoutError, match="of 2 ranks did not finish"):
        run_ranks(workers.hang_on_one, 2, device="cpu", timeout=10)
    with pytest.raises(ValueError, match="unknown backend"):
        run_ranks(workers.world, 1, backend="mpi", device="cpu")


def test_run_ranks_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    """No ``device``: the card; with none visible, ``NoCudaDeviceError``
    before any rank starts (no fallback to the host)."""
    from repro_torch.core.timing import NoCudaDeviceError

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NoCudaDeviceError, match="device='cpu'"):
        run_ranks(workers.world, 2, timeout=120)

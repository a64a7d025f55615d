"""``repro_torch.perfmodel.hlo`` against ``repro.perfmodel.hlo``, and the
port's other source of collective stats: the calls one rank recorded
(``dist.collectives.recording``) on a mesh placed without a world
(``Mesh.place``).

The HLO parsers are the port's own copy of the reference's text parsing,
so they must agree exactly: on the reference's own fixtures, and on the
HLO text of the reference's compiled (2, 4) olmoe-1b-7b dry-run cell,
built in a subprocess with 8 fake XLA devices (as
``tests/test_dist.py::test_small_mesh_dryrun_cell_compiles`` builds it).
"""
from __future__ import annotations

import os
import tempfile
from functools import lru_cache

import pytest
import torch

import test_perfmodel as jfixtures
from repro.perfmodel import hlo as jhlo
from repro_torch.dist import collectives
from repro_torch.launch.mesh import Mesh
from repro_torch.perfmodel import hlo as thlo
from utils import run_with_devices

TYPES = ("f32[128,256]", "bf16[2,2]{1,0}", "(f32[4], bf16[8])", "pred[]", "s8[3,5]",
         "f8e4m3fn[16]", "(bf16[4,8]{1,0}, bf16[4,8]{1,0})", "token[]", "c64[2]")
OPS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute",
       "fusion", "dot", "while", "convolution", "custom-call")


@lru_cache(maxsize=None)
def _olmoe_cell_hlo() -> str:
    """The compiled HLO text of the reference's reduced olmoe train cell on
    its (2, 4) test mesh."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "cell.hlo.txt")
        run_with_devices(
            f"""
            import dataclasses
            from repro.configs import get_config, get_shape
            from repro.launch.cell import build_cell
            from repro.launch.mesh import make_test_mesh

            cfg = get_config("olmoe-1b-7b").reduced().replace(vocab_size=512)
            shape = dataclasses.replace(get_shape("train_4k"), seq_len=128, global_batch=8)
            cell = build_cell(cfg, shape, make_test_mesh())
            open({path!r}, "w").write(cell.lower().compile().as_text())
            """
        )
        with open(path) as f:
            return f.read()


def _stats(s) -> dict:
    return s.summary()


@pytest.mark.parametrize("type_str", TYPES)
def test_shape_bytes_equals_the_reference(type_str):
    assert thlo._shape_bytes(type_str) == jhlo._shape_bytes(type_str)


@pytest.mark.parametrize("text", ["HLO_FLAT", "HLO_LOOP"])
def test_fixtures_equal_the_reference(text):
    hlo = getattr(jfixtures, text)
    for group in (1, 4):
        assert _stats(thlo.collective_bytes(hlo, group)) == _stats(
            jhlo.collective_bytes(hlo, group))
    for op in OPS:
        assert thlo.count_op(hlo, op) == jhlo.count_op(hlo, op)


def test_compiled_cell_hlo_equals_the_reference():
    hlo = _olmoe_cell_hlo()
    got, want = thlo.collective_bytes(hlo), jhlo.collective_bytes(hlo)
    assert want.per_device_bytes > 0 and _stats(got) == _stats(want)
    assert thlo._split_computations(hlo) == jhlo._split_computations(hlo)
    for op in OPS:
        assert thlo.count_op(hlo, op) == jhlo.count_op(hlo, op)
    lines = hlo.splitlines()
    assert [thlo._line_collective(ln, 8) for ln in lines] == [
        jhlo._line_collective(ln, 8) for ln in lines]


def _placed(rank=0):
    return Mesh((2, 4), ("data", "model")).place(rank)


def test_place_fixes_a_rank_without_a_world():
    mesh = Mesh((2, 2, 4), ("pod", "data", "model")).place(13)
    assert mesh.index("pod") == 1 and mesh.index("data") == 1 and mesh.index("model") == 1
    assert mesh.axis_ranks("model") == [12, 13, 14, 15]
    assert mesh.axis_ranks("data") == [9, 13]
    assert mesh.device == torch.device("meta")
    with pytest.raises(RuntimeError, match="without a world"):
        mesh.group("model")
    with pytest.raises(ValueError):
        Mesh((2,), ("model",)).place(2)


def test_dry_recording_returns_meta_results_and_records_each_call():
    mesh = _placed(rank=5)  # data 1, model 1
    x = torch.empty((8, 6), dtype=torch.bfloat16, device="meta")
    y = torch.empty((4, 12), dtype=torch.float32, device="meta")
    with collectives.recording() as rec:
        got = {
            "all_reduce": collectives.all_reduce(x, mesh, "model"),
            "all_gather": collectives.all_gather(y, mesh, "model", dim=1),
            "reduce_scatter": collectives.reduce_scatter(y, mesh, "model", 1),
            "broadcast": collectives.broadcast(x, mesh, "data", 0),
            "reduce": collectives.reduce(x, mesh, "data", 1),
            "reduce_elsewhere": collectives.reduce(x, mesh, "data", 0),
            "shift": collectives.shift(y, mesh, "data"),
        }
    assert got["all_reduce"].shape == (8, 6) and got["all_reduce"].dtype == torch.bfloat16
    assert got["all_gather"].shape == (4, 48) and got["reduce_scatter"].shape == (4, 3)
    assert got["broadcast"].shape == (8, 6) and got["shift"].shape == (4, 12)
    assert got["reduce"].shape == (8, 6) and got["reduce_elsewhere"] is None
    assert all(t is None or t.device.type == "meta" for t in got.values())
    calls = [(c.op, c.axis, c.n, c.payload_bytes, c.wire_bytes) for c in rec.calls]
    assert calls == [("all_reduce", "model", 4, 96, 192), ("all_gather", "model", 4, 192, 192),
                     ("reduce_scatter", "model", 4, 192, 192), ("broadcast", "data", 2, 96, 96),
                     ("reduce", "data", 2, 96, 192), ("reduce", "data", 2, 96, 192),
                     ("shift", "data", 2, 192, 192)]
    assert rec.by_op()["reduce"] == {"calls": 2, "bytes": 192}
    with pytest.raises(RuntimeError, match="without a world"):  # outside: a real call
        collectives.all_reduce(x, mesh, "model")


def test_recorded_stats_apply_the_ring_conventions():
    rec = [collectives.CollectiveCall("all_reduce", "model", 4, 96, 192),
           collectives.CollectiveCall("all_gather", "model", 4, 100, 100),
           collectives.CollectiveCall("reduce_scatter", "data", 2, 100, 100),
           collectives.CollectiveCall("shift", "data", 2, 64, 64),
           collectives.CollectiveCall("broadcast", "data", 2, 32, 32),
           collectives.CollectiveCall("reduce", "data", 2, 16, 32),
           collectives.CollectiveCall("all_reduce", "model", 1, 96, 192)]
    s = thlo.recorded_stats(rec)
    assert dict(s.op_counts) == {"all-reduce": 2, "all-gather": 1, "reduce-scatter": 1,
                                 "collective-permute": 1, "broadcast": 1, "reduce": 1}
    want = {"all-reduce": 2 * 192 * 3 / 4, "all-gather": 400 * 3 / 4,
            "reduce-scatter": 50 * 1, "collective-permute": 64, "broadcast": 32, "reduce": 32}
    assert dict(s.op_bytes) == pytest.approx(want)
    assert s.per_device_bytes == pytest.approx(sum(want.values()))
    assert s.payload_bytes == 192 + 400 + 50 + 64 + 32 + 32 + 192
    # the same calls as HLO text give the same all-reduce term
    hlo = """
ENTRY %main (p0: f32[48]) -> f32[48] {
  %p0 = f32[48] parameter(0)
  ROOT %ar = f32[48] all-reduce(%p0), replica_groups=[4,4]<=[16], to_apply=%add
}
"""
    assert thlo.collective_bytes(hlo).per_device_bytes == s.op_bytes["all-reduce"]

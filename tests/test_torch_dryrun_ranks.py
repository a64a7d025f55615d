"""The dry run's recorded collectives against a real run of the same cell.

``Cell.lower(rank)`` runs one rank's program on the ``meta`` device with
its collectives recorded, not sent.  Here each rank of a real gloo world on
the CPU runs the same cell's step on its shards of seeded arguments, its
collectives recorded as they run (``dist.collectives.recording(dry=False)``,
the calls the program makes).
Every rank's calls and payload bytes by op must equal its dry run's
exactly: reduced gemma-2b and olmoe-1b-7b train cells on (data 2, model 2)
at ZeRO 1-3 (and 2 microbatches at ZeRO 3), prefill and decode cells on
(model 2), and gemma-2b, zamba2-7b and xlstm-1.3b decode cells on (data 2,
model 2), whose outputs must also equal the whole step's.
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache

import pytest

from repro_torch.configs import get_config, get_shape
from repro_torch.dist import collectives, run_ranks
from repro_torch.launch.cell import build_cell
from repro_torch.launch.mesh import Mesh

import torch_dist_workers as workers

TRAIN = [(arch, {"zero_stage": z}, "train_4k", 32, 4, (2, 2), ("data", "model"))
         for arch in ("gemma-2b", "olmoe-1b-7b") for z in (1, 2, 3)]
TRAIN.append(("gemma-2b", {"zero_stage": 3, "train_microbatches": 2}, "train_4k", 32, 4,
              (2, 2), ("data", "model")))
SERVE = [(arch, {}, shape, 32, 2, (2,), ("model",))
         for arch in ("gemma-2b", "olmoe-1b-7b") for shape in ("prefill_32k", "decode_32k")]
# decode on (data 2, model 2), where the reference's cache rule reads a
# leaf's dim 1 as its lanes but the leaf holds them elsewhere (zamba2's x0,
# xlstm's mLSTM state), so the step relays the cache out and back
DECODE_DP = [(arch, {}, "decode_32k", 32, 4, (2, 2), ("data", "model"))
             for arch in ("gemma-2b", "zamba2-7b", "xlstm-1.3b")]
CASES = {"train": TRAIN, "serve": SERVE, "decode_dp": DECODE_DP}
RANKS = {"train": 4, "serve": 2, "decode_dp": 4}


@lru_cache(maxsize=None)
def _real(which: str) -> list:
    return run_ranks(workers.cell_collectives, RANKS[which], CASES[which], device="cpu",
                     timeout=300)


def _dry(case, rank) -> dict:
    arch, kw, shape, seq, batch, mesh_shape, axes = case
    cell = build_cell(get_config(arch).reduced().replace(**kw),
                      dataclasses.replace(get_shape(shape), seq_len=seq, global_batch=batch),
                      Mesh(mesh_shape, axes))
    return collectives.by_op(cell.lower(rank).calls)


@pytest.mark.parametrize("which,i", [(w, i) for w, cases in CASES.items()
                                     for i in range(len(cases))])
def test_dry_run_records_what_a_real_run_calls(which, i):
    case = CASES[which][i]
    for rank, got in enumerate(_real(which)):
        want = got[i]["collectives"]
        assert want, case  # every cell here calls collectives
        assert _dry(case, rank) == want, (case, rank)
        if "max_rel_err" in got[i]:  # float32 compute: the sums in another order
            assert got[i]["max_rel_err"] < 1e-5, (case, rank, got[i]["max_rel_err"])

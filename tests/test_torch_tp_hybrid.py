"""zamba2-7b ``reduced()`` on a ``model`` mesh, the port against the
reference's unsharded function, on gloo CPU ranks.

Eight Mamba2 heads of 16 channels, 4 query heads and 2 KV heads in the
shared block: at tp 2 each rank holds 4 Mamba2 heads (its columns of
``w_in``, its rows of ``w_out``) and one KV head; at tp 4 two Mamba2 heads,
with the shared block's KV heads whole (read by the local query heads).
Every whole Mamba2 leaf a rank reads in part (``w_z``, ``w_dt``,
``dt_bias``, ``A_log``, ``D``, ``conv_w``, ``conv_b``, ``out_norm``) starts
perturbed off its constant init, so a wrong head slice shows in the forward
and a missing ``copy`` in the grads.  Compared (``torch_tp_families``): the
forward, the loss and every rank's slice of ``jax.grad``, the prefill with
every cache leaf gathered per the rule (the shared attention's K/V split
where the axis divides the KV heads, ``ssm`` and ``conv`` whole), and 8
greedy ``decode_step``s.  ``ssm_impl``/``attn_impl`` "pallas" (the scan and
flash wrappers on each rank's heads, their plain versions on the CPU; the
reference in interpret mode) runs the forms without grads.
"""
from functools import lru_cache

import pytest

from repro_torch.dist import run_ranks

import torch_dist_workers as workers
import torch_tp_families as F

NAME = "zamba2-7b"
CASES = {"xla": (), "pallas": (("ssm_impl", "pallas"), ("attn_impl", "pallas"))}
TPS = (2, 4)


@lru_cache(maxsize=None)
def _ranks(tp):
    cases = [(NAME, F.np_params(NAME, kw), dict(kw), F.batch(NAME, kw)) for kw in CASES.values()]
    res = run_ranks(workers.tp_family, tp, tp, cases, F.STEPS, device="cpu", timeout=300)
    return {case: [r[i] for r in res] for i, case in enumerate(CASES)}


@pytest.mark.parametrize("tp", TPS)
@pytest.mark.parametrize("case", list(CASES))
def test_zamba_on_a_model_mesh_equals_the_reference(tp, case):
    grads = case == "xla"
    want = F.reference(NAME, CASES[case], grads=grads)
    for rank, got in enumerate(_ranks(tp)[case]):
        F.check_rank(got, want, f"{case} tp {tp} rank {rank}", grads=grads)


@pytest.mark.parametrize("tp", TPS)
def test_zamba_cache_and_params_follow_the_rule(tp):
    """Each rank's cache: its KV heads where the axis divides them, the SSM
    and conv state whole; its grads: its heads' columns of ``w_in``, rows of
    ``w_out``, the whole leaves whole."""
    got = _ranks(tp)["xla"][1]
    kv = 2 // tp if 2 % tp == 0 else 2
    assert got["cache_local"]["k"][3] == kv
    assert got["cache_local"]["ssm"] == (5, 2, 8, 16, 16)
    assert got["cache_local"]["conv"] == (5, 2, 3, 128 + 2 * 16)
    sup = got["slices"]["supers"]
    d_in = 128
    assert sup["w_in"][-1] == (d_in // tp, 2 * d_in // tp)
    assert sup["w_out"][-2] == (d_in // tp, 2 * d_in // tp)
    whole = F.np_params(NAME)
    for leaf in ("w_z", "w_dt", "A_log", "D", "conv_w", "conv_b"):
        assert all(b - a == n for (a, b), n in zip(sup[leaf], whole["supers"][leaf].shape))
    mlp = got["slices"]["shared_attn"]["mlp"]
    assert all(b - a == n for leaf in mlp for (a, b), n in
               zip(mlp[leaf], whole["shared_attn"]["mlp"][leaf].shape))

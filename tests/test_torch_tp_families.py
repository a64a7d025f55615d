"""xlstm-1.3b, whisper-base and internvl2-76b ``reduced()`` on a ``model``
mesh, the port against the reference's unsharded function, on gloo CPU
ranks, at tp 2 and tp 4.

- xlstm-1.3b: only ``embed`` and ``lm_head`` split (on the vocab); the
  blocks and their recurrent state are whole on every rank.
- whisper-base (4 query heads, 2 KV heads, q/k/v biases): the encoder, the
  decoder's self and cross attention on the local heads, the cross K/V split
  where the axis divides the KV heads (tp 2) and whole otherwise (tp 4);
  the head tied to the vocab-split embedding.  With ``vocab_size`` 250 (a
  padded vocab of 256) the pad columns are masked after the gather, by
  their global index.
- internvl2-76b: the VLM with its 8-patch frontend prepended after the
  embedding's vocab sum.

Compared (``torch_tp_families``): the forward, the loss and every rank's
slice of ``jax.grad``, the prefill with every cache leaf gathered per the
rule, and 8 greedy ``decode_step``s.
"""
from functools import lru_cache

import pytest

from repro_torch.dist import run_ranks

import torch_dist_workers as workers
import torch_tp_families as F

CASES = {"xlstm-1.3b": ("xlstm-1.3b", ()),
         "whisper-base": ("whisper-base", ()),
         "whisper-base-padded-vocab": ("whisper-base", (("vocab_size", 250),)),
         "internvl2-76b": ("internvl2-76b", ())}
TPS = (2, 4)


@lru_cache(maxsize=None)
def _ranks(tp):
    cases = [(name, F.np_params(name, kw), dict(kw), F.batch(name, kw))
             for name, kw in CASES.values()]
    res = run_ranks(workers.tp_family, tp, tp, cases, F.STEPS, device="cpu", timeout=300)
    return {case: [r[i] for r in res] for i, case in enumerate(CASES)}


@pytest.mark.parametrize("tp", TPS)
@pytest.mark.parametrize("case", list(CASES))
def test_family_on_a_model_mesh_equals_the_reference(tp, case):
    want = F.reference(*CASES[case])
    for rank, got in enumerate(_ranks(tp)[case]):
        F.check_rank(got, want, f"{case} tp {tp} rank {rank}")


@pytest.mark.parametrize("tp", TPS)
def test_family_caches_follow_the_rule(tp):
    """The cross K/V and the self K/V split on ``model`` where the axis
    divides the 2 KV heads; the xLSTM's state whole."""
    kv = 2 // tp if 2 % tp == 0 else 2
    whisper = _ranks(tp)["whisper-base"][-1]["cache_local"]
    assert all(whisper[k][3] == kv for k in ("self_k", "self_v", "cross_k", "cross_v"))
    assert _ranks(tp)["internvl2-76b"][-1]["cache_local"]["k"][3] == kv
    xl = _ranks(tp)["xlstm-1.3b"][-1]["cache_local"]
    assert xl["mC"] == (2, 1, 2, 4, 16, 16) and xl["sh"] == (2, 2, 4, 16)
    assert _ranks(tp)["xlstm-1.3b"][-1]["slices"]["lm_head"][1] == (256 - 256 // tp, 256)

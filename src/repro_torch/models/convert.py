"""Carry the reference's parameters into the port.

``params_from_jax`` takes the reference's init pytree as numpy arrays
(``jax.tree.map(np.asarray, params)``) and returns the port's params: the
same nested dict, the same shapes and dtypes, as torch tensors on
``device``.  The dense LM's (``lm_init``) are layer-stacked with a leading
``n_layers`` axis; the hybrid's (``zamba_init``) lead with ``(n_super,
per)`` under ``supers`` and ``(tail,)`` under ``tail``.  The tests use it to
give both packages the same weights.
"""
from __future__ import annotations

import numpy as np
import torch

from .common import tree_leaves, tree_map
from .mamba import _zamba_counts

_DTYPES = {"float32": torch.float32, "float16": torch.float16, "bfloat16": torch.bfloat16}


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name not in _DTYPES:
        raise TypeError(f"parameter of dtype {a.dtype} (expected one of {sorted(_DTYPES)})")
    # bfloat16 has no numpy dtype of its own (ml_dtypes): go through float32, which is exact
    t = torch.tensor(a.astype(np.float32) if a.dtype.name == "bfloat16" else a)
    return t.to(device=device, dtype=_DTYPES[a.dtype.name])


def _stacks(cfg) -> dict:
    """Each stacked subtree and the leading shape its leaves must have."""
    if cfg.family == "dense":
        return {"layers": (cfg.n_layers,)}
    n_super, per, tail = _zamba_counts(cfg)
    return {"supers": (n_super, per), **({"tail": (tail,)} if tail else {})}


def params_from_jax(tree, cfg, device="cuda") -> dict:
    """The reference's dense-LM or hybrid params (numpy leaves) as the port's,
    on ``device`` (the card unless the caller passes ``"cpu"``)."""
    if cfg.family == "dense":
        want = {"embed", "layers", "final_norm"} | (set() if cfg.tie_embeddings else {"lm_head"})
    elif cfg.family == "hybrid":
        want = {"embed", "supers", "shared_attn", "final_norm", "lm_head"} | set(_stacks(cfg))
    else:
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet (ROADMAP.md)")
    if set(tree) != want:
        raise ValueError(f"params have keys {sorted(tree)}, expected {sorted(want)}")
    params = tree_map(lambda a: _tensor(a, device), tree)
    for name, lead in _stacks(cfg).items():
        for leaf in tree_leaves(params[name]):
            if tuple(leaf.shape[:len(lead)]) != lead:
                raise ValueError(f"{name} has a leaf of shape {tuple(leaf.shape)}, expected "
                                 f"leading axes {lead}")
    return params

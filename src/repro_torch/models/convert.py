"""Carry the reference's parameters into the port.

``params_from_jax`` takes the reference's ``lm_init`` pytree as numpy arrays
(``jax.tree.map(np.asarray, params)``, layer-stacked with a leading
``n_layers`` axis) and returns the port's params: the same nested dict, the
same shapes and dtypes, as torch tensors on ``device``.  The tests use it to
give both packages the same weights.
"""
from __future__ import annotations

import numpy as np
import torch

from .common import tree_map

_DTYPES = {"float32": torch.float32, "float16": torch.float16, "bfloat16": torch.bfloat16}


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name not in _DTYPES:
        raise TypeError(f"parameter of dtype {a.dtype} (expected one of {sorted(_DTYPES)})")
    # bfloat16 has no numpy dtype of its own (ml_dtypes): go through float32, which is exact
    t = torch.tensor(a.astype(np.float32) if a.dtype.name == "bfloat16" else a)
    return t.to(device=device, dtype=_DTYPES[a.dtype.name])


def params_from_jax(tree, cfg, device="cpu") -> dict:
    """The reference's dense-LM params (numpy leaves) as the port's."""
    if cfg.family != "dense":
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet (ROADMAP.md)")
    want = {"embed", "layers", "final_norm"} | (set() if cfg.tie_embeddings else {"lm_head"})
    if set(tree) != want:
        raise ValueError(f"params have keys {sorted(tree)}, expected {sorted(want)}")
    params = tree_map(lambda a: _tensor(a, device), tree)
    for name, leaf in params["layers"]["attn"].items():
        if leaf.shape[0] != cfg.n_layers:
            raise ValueError(f"layers.attn.{name} has {leaf.shape[0]} layers, "
                             f"expected {cfg.n_layers}")
    return params

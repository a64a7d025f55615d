"""Carry the reference's parameters into the port.

``params_from_jax`` takes the reference's init pytree as numpy arrays
(``jax.tree.map(np.asarray, params)``) and returns the port's params: the
same nested dict, the same shapes and dtypes, as torch tensors on
``device``.  The transformer LM's (``lm_init``: dense, MoE and VLM) are
layer-stacked with a leading ``n_layers`` axis (the MoE leaves are (L, E,
d, f)); the encoder-decoder's (``encdec_init``) lead with
``(n_enc_layers,)`` under ``enc_layers`` and ``(n_dec_layers,)`` under
``dec_layers``; the xLSTM's (``xlstm_init``) with ``(n_macros,
mlstm_per_macro)`` under ``macros/mlstm`` and ``(n_macros,)`` under
``macros/slstm``; the hybrid's (``zamba_init``) lead with ``(n_super, per)``
under ``supers`` and ``(tail,)`` under ``tail``.  The tests use it to
give both packages the same weights.
"""
from __future__ import annotations

import numpy as np
import torch

from .common import tree_leaves, tree_map
from .mamba import _zamba_counts
from .xlstm import n_macros

_DTYPES = {"float32": torch.float32, "float16": torch.float16, "bfloat16": torch.bfloat16}


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name not in _DTYPES:
        raise TypeError(f"parameter of dtype {a.dtype} (expected one of {sorted(_DTYPES)})")
    # bfloat16 has no numpy dtype of its own (ml_dtypes): go through float32, which is exact
    t = torch.tensor(a.astype(np.float32) if a.dtype.name == "bfloat16" else a)
    return t.to(device=device, dtype=_DTYPES[a.dtype.name])


def _stacks(cfg) -> dict:
    """Each stacked subtree (its path of keys) and the leading shape its
    leaves must have."""
    if cfg.family in ("dense", "moe", "vlm"):
        return {("layers",): (cfg.n_layers,)}
    if cfg.family == "encdec":
        return {("enc_layers",): (cfg.n_enc_layers,), ("dec_layers",): (cfg.n_dec_layers,)}
    if cfg.family == "ssm":
        nm = n_macros(cfg)
        return {("macros", "mlstm"): (nm, cfg.xlstm_mlstm_per_macro), ("macros", "slstm"): (nm,)}
    n_super, per, tail = _zamba_counts(cfg)
    return {("supers",): (n_super, per), **({("tail",): (tail,)} if tail else {})}


def params_from_jax(tree, cfg, device="cuda") -> dict:
    """The reference's params (numpy leaves) of any family as the port's, on
    ``device`` (the card unless the caller passes ``"cpu"``)."""
    if cfg.family in ("dense", "moe", "vlm"):
        want = {"embed", "layers", "final_norm"} | (set() if cfg.tie_embeddings else {"lm_head"})
    elif cfg.family == "encdec":
        want = {"embed", "enc_layers", "dec_layers", "enc_norm", "dec_norm"}
    elif cfg.family == "ssm":
        want = {"embed", "macros", "final_norm", "lm_head"}
    elif cfg.family == "hybrid":
        want = {"embed", "supers", "shared_attn", "final_norm", "lm_head"} | (
            {"tail"} if _zamba_counts(cfg)[2] else set())
    else:
        raise ValueError(f"unknown family {cfg.family!r}")
    if set(tree) != want:
        raise ValueError(f"params have keys {sorted(tree)}, expected {sorted(want)}")
    params = tree_map(lambda a: _tensor(a, device), tree)
    for path, lead in _stacks(cfg).items():
        sub = params
        for key in path:
            sub = sub[key]
        for leaf in tree_leaves(sub):
            if tuple(leaf.shape[:len(lead)]) != lead:
                raise ValueError(f"{'/'.join(path)} has a leaf of shape {tuple(leaf.shape)}, "
                                 f"expected leading axes {lead}")
    return params

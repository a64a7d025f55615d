"""ZeRO partitioning: spread replicated state over the data axis.

Port of ``repro.dist.zero``.  ``zero1_state_specs`` takes the
tensor-parallel param specs and additionally shards, over ``data``, the
first dim of each leaf that is still replicated and divides the data-axis
size.  ``zero_layouts`` is the staging policy of the reference's
``launch/cell.py::_build_train``: which tree lives in which layout at each
``cfg.zero_stage``.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

from repro_torch.launch.mesh import Mesh

from .sharding import NamedSharding, P, param_specs, tree_map2


def zero1_state_specs(shapes, pspecs, mesh: Mesh):
    if "data" not in mesh.shape or mesh.shape["data"] == 1:
        return pspecs
    dsize = mesh.shape["data"]

    def one(leaf, sh: NamedSharding) -> NamedSharding:
        spec = list(sh.spec) + [None] * (leaf.ndim - len(sh.spec))
        for i, dim in enumerate(leaf.shape):
            if spec[i] is None and dim >= dsize and dim % dsize == 0:
                spec[i] = "data"
                break
        return NamedSharding(mesh, P(*spec))

    return tree_map2(one, shapes, pspecs)


class ZeroLayouts(NamedTuple):
    """Per-tree layouts of a training state at one ZeRO stage."""

    params: Any  # where the fp32 params are stored between steps
    moments: Any  # AdamW's mu and nu
    grads: Optional[Any]  # the reduced grads (None: param_specs, all-reduced)


def zero_layouts(shapes, cfg, mesh: Mesh) -> ZeroLayouts:
    """The reference's ZeRO staging: 1 = optimizer state sharded over data;
    2 = + grads reduce-scattered into that layout; 3 = + fp32 params stored
    in it (gathered whole for the forward)."""
    pspecs = param_specs(shapes, cfg, mesh)
    zspecs = zero1_state_specs(shapes, pspecs, mesh)
    return ZeroLayouts(
        params=zspecs if cfg.zero_stage >= 3 else pspecs,
        moments=zspecs if cfg.zero_stage >= 1 else pspecs,
        grads=zspecs if cfg.zero_stage >= 2 else None,
    )

"""repro_torch.dist — the distribution layer on ``torch.distributed``.

Port of ``repro.dist``, SPMD: one process per rank, each holding its shard.

- ``sharding``         name-based parameter specs, placement (``shard_tree``)
- ``zero``             ZeRO-1/2/3 state partitioning over the data axis, and
                       ZeRO-3's gathers a layer at a time
- ``compress``         int8 gradient compression for cross-pod links
- ``pipeline``         GPipe microbatch pipelining over a mesh axis
- ``tensor_parallel``  Megatron's collectives on the ``model`` axis, each
                       with its conjugate in the backward
- ``data_parallel``    means over the global batch on the batch axes
- ``collectives``      the collectives those imply, over one mesh axis
- ``launcher``         ``run_ranks``: a function on N local ranks;
                       ``RankGroup``: N ranks kept between calls

The reference's ``_compat`` (a shim for JAX versions) has no twin.
"""
from .compress import dequantize_int8, psum_compressed, quantize_int8
from .launcher import RankGroup, choose_backend, rank_device, rank_state, run_ranks
from .pipeline import gpipe_apply
from .sharding import (
    NamedSharding,
    P,
    PartitionSpec,
    activation_sharding,
    batch_shardings,
    cache_shardings,
    gather_tree,
    logits_sharding,
    paged_cache_shardings,
    param_specs,
    shard_act,
    shard_params,
    shard_tree,
)
from .zero import ZeroLayouts, zero1_state_specs, zero_layouts

__all__ = [
    "NamedSharding",
    "P",
    "PartitionSpec",
    "RankGroup",
    "ZeroLayouts",
    "activation_sharding",
    "batch_shardings",
    "cache_shardings",
    "choose_backend",
    "dequantize_int8",
    "gather_tree",
    "gpipe_apply",
    "logits_sharding",
    "paged_cache_shardings",
    "param_specs",
    "psum_compressed",
    "quantize_int8",
    "rank_device",
    "rank_state",
    "run_ranks",
    "shard_act",
    "shard_params",
    "shard_tree",
    "zero1_state_specs",
    "zero_layouts",
]

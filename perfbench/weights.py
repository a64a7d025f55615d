"""Seeded weights in the program's parameter layout, made by the benchmark.

The layout (the nested dict of leaf names and shapes) is read from the
program's own initializer run on fake tensors, which allocate nothing; the
values are the benchmark's: each leaf is drawn on the device by a generator
seeded from the run's seed and the leaf's index, in one call, so that any
leaf can be made again alone (the references make them again leaf by leaf).
"""
from __future__ import annotations

import math

import torch

#: leaves that start at a constant, by name
ONES = ("scale", "D")
ZEROS = ("bias", "A_log", "dt_bias", "conv_b", "bq", "bk", "bv")
#: leaves drawn at a fixed standard deviation, by name
FIXED_STD = {"embed": 0.02, "lm_head": 0.02, "conv_w": 0.1}


def leaf_paths(tree, prefix: tuple = ()) -> list:
    """(path, leaf) pairs of a nested dict, depth first in insertion order."""
    if isinstance(tree, dict):
        return [pl for k, v in tree.items() for pl in leaf_paths(v, prefix + (k,))]
    return [(prefix, tree)]


def _std(path: tuple, shape: tuple) -> float:
    name = path[-1]
    if name in FIXED_STD:
        return FIXED_STD[name]
    if len(path) > 1 and path[-2] == "attn":
        fan_in = shape[-3] if name in ("wq", "wk", "wv") else shape[-3] * shape[-2]
    else:
        fan_in = shape[-2]
    return 1.0 / math.sqrt(fan_in)


def leaf_seed(seed: int, index: int) -> int:
    """A generator seed for leaf ``index`` of a run's weights."""
    return (int(seed) * 1_000_003 + 7919 * index + 1) % (1 << 62)


def make_leaf(seed: int, index: int, path: tuple, shape: tuple, dtype, device) -> torch.Tensor:
    """Leaf ``index`` of the weights of ``seed``: the same on every call."""
    name = path[-1]
    if name in ONES:
        return torch.ones(shape, dtype=dtype, device=device)
    if name in ZEROS:
        return torch.zeros(shape, dtype=dtype, device=device)
    gen = torch.Generator(device=device).manual_seed(leaf_seed(seed, index))
    out = torch.empty(shape, dtype=torch.float32, device=device)
    out.normal_(0.0, _std(path, shape), generator=gen)
    return out.to(dtype)


def layout(model_init) -> list:
    """(path, shape, dtype) of each leaf the program's ``model_init(gen)``
    makes, read on fake tensors (nothing is allocated)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        tree = model_init(torch.Generator())
    return [(path, tuple(leaf.shape), leaf.dtype) for path, leaf in leaf_paths(tree)]


def build(spec: list, seed: int, device) -> dict:
    """The nested dict of weights for ``spec`` (from :func:`layout`)."""
    tree: dict = {}
    for index, (path, shape, dtype) in enumerate(spec):
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = make_leaf(seed, index, path, shape, dtype, device)
    return tree


def get(tree: dict, path: tuple):
    for key in path:
        tree = tree[key]
    return tree

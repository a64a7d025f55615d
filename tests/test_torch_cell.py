"""``repro_torch.launch.cell``'s analytic parts against ``repro.launch.cell``:
``input_specs``, the parameter counts and the whole ``analytic_memory``
dict, exactly (integers), on the production meshes.

The reference's side builds its cells with no compile (``jax.eval_shape``
only) in one subprocess with 512 fake XLA devices; the port's builds them on
abstract meshes over ``meta`` tensors.  Covered: every arch on ``train_4k``
at the single-pod mesh, every shape gemma-2b supports at both meshes, and
dbrx-132b's prefill and decode at both, where ``serve_param_fsdp`` splits
the served params over ``data`` too.
"""
from __future__ import annotations

import json
import os
import tempfile
from functools import lru_cache

import pytest

from repro_torch.configs import CONFIGS, SHAPES, get_config, get_shape
from repro_torch.launch.cell import analytic_memory, build_cell
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.api import input_specs
from utils import run_with_devices

CELLS = sorted({(arch, "train_4k", False) for arch in CONFIGS}
               | {("gemma-2b", s, m) for s in SHAPES for m in (False, True)
                  if get_config("gemma-2b").supports_shape(get_shape(s))}
               | {("dbrx-132b", s, m) for s in ("prefill_32k", "decode_32k")
                  for m in (False, True)})
SPECS = sorted((arch, s) for arch in CONFIGS for s in SHAPES
               if get_config(arch).supports_shape(get_shape(s)))


@lru_cache(maxsize=None)
def _reference() -> dict:
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ref.json")
        run_with_devices(
            f"""
            import json
            from repro.configs import get_config, get_shape
            from repro.launch.cell import analytic_memory, build_cell
            from repro.launch.mesh import make_production_mesh
            from repro.models.api import input_specs

            def flat(tree, path=""):
                if isinstance(tree, dict):
                    out = {{}}
                    for k, v in tree.items():
                        out.update(flat(v, f"{{path}}/{{k}}"))
                    return out
                return {{path: [list(tree.shape), str(tree.dtype)]}}

            out = {{"cells": {{}}, "specs": {{}}}}
            for arch, shape, multi in {CELLS!r}:
                cell = build_cell(get_config(arch), get_shape(shape),
                                  make_production_mesh(multi_pod=multi))
                out["cells"][f"{{arch}} {{shape}} {{multi}}"] = {{
                    "n_params": cell.n_params, "n_params_active": cell.n_params_active,
                    "analytic_memory": analytic_memory(cell)}}
            for arch, shape in {SPECS!r}:
                out["specs"][f"{{arch}} {{shape}}"] = flat(
                    input_specs(get_config(arch), get_shape(shape)))
            open({path!r}, "w").write(json.dumps(out))
            """,
            n_devices=512,
        )
        with open(path) as f:
            return json.load(f)


def _flat(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{path}/{k}"))
        return out
    return {path: [list(tree.shape), str(tree.dtype).removeprefix("torch.")]}


def _flat_tensors(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _flat_tensors(v)]
    return [tree]


@pytest.mark.parametrize("arch,shape", SPECS)
def test_input_specs_equal_the_reference(arch, shape):
    got = input_specs(get_config(arch), get_shape(shape))
    assert all(t.device.type == "meta" for t in _flat_tensors(got))
    assert _flat(got) == _reference()["specs"][f"{arch} {shape}"]


@pytest.mark.parametrize("arch,shape,multi", CELLS)
def test_counts_and_analytic_memory_equal_the_reference(arch, shape, multi):
    cell = build_cell(get_config(arch), get_shape(shape), make_production_mesh(multi_pod=multi))
    want = _reference()["cells"][f"{arch} {shape} {multi}"]
    assert cell.n_params == want["n_params"]
    assert cell.n_params_active == want["n_params_active"]
    assert analytic_memory(cell) == want["analytic_memory"]
    assert cell.name == f"{arch}__{shape}__{'multi' if multi else 'single'}"


def test_serve_param_fsdp_splits_the_served_params_over_data():
    """dbrx-132b alone sets it: its served params take ZeRO-1's layout over
    ``data`` on top of the ``model`` split, so a rank holds a sixteenth of
    what the ``model`` split alone leaves it."""
    cfg = get_config("dbrx-132b")
    assert cfg.serve_param_fsdp
    mesh = make_production_mesh()
    on = analytic_memory(build_cell(cfg, get_shape("decode_32k"), mesh))["param_bytes"]
    off = analytic_memory(build_cell(cfg.replace(serve_param_fsdp=False),
                                     get_shape("decode_32k"), mesh))["param_bytes"]
    assert off == 16 * on

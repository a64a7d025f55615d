"""Sharded checkpoints, resharded restore and the elastic restart policy of
the port, against the reference, on gloo CPU ranks.

A tree sharded on (data=2, model=1) is saved from its shards (rank 0 writes
the global arrays), then restored on (data=1, model=2): each rank's shards
equal the slices of the saved tree, bit for bit.  ``ElasticController``
resumes the same checkpoint on one rank (the planned mesh, the step, the
tree, the data pipeline's seek) and raises the reference's error when too
few devices are healthy.  A checkpoint the reference writes restores into a
sharded port tree, and one the port writes from shards restores in the
reference.
"""
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.ckpt import CheckpointManager as JCheckpointManager
from repro.ft import ElasticController as JElasticController
from repro_torch.ckpt import CheckpointManager
from repro_torch.dist import run_ranks
from repro_torch.ft import ElasticController

import torch_dist_workers as workers


def _tree():
    rng = np.random.default_rng(0)
    return {"w": rng.normal(size=(8, 6)).astype(np.float32),
            "b": rng.normal(size=(6,)).astype(np.float32)}


def test_save_on_data_2_restore_on_another_mesh_and_on_one_rank():
    tree = _tree()
    with tempfile.TemporaryDirectory() as d, tempfile.TemporaryDirectory() as ref_d:
        JCheckpointManager(ref_d).save(5, {k: jnp.asarray(v) for k, v in tree.items()})
        res = run_ranks(workers.save_then_reshard, 2, d, tree, ref_d, device="cpu", timeout=120)
        for rank, r in enumerate(res):
            assert r["step"] == 3 and r["ref_step"] == 5
            # (data=1, model=2): w split on its columns, b on its only dim
            np.testing.assert_array_equal(r["moved"]["w"], tree["w"][:, 3 * rank:3 * rank + 3])
            np.testing.assert_array_equal(r["moved"]["b"], tree["b"][3 * rank:3 * rank + 3])
            # the reference's checkpoint on (data=2, model=1): w split on its rows
            np.testing.assert_array_equal(r["ref"]["w"], tree["w"][4 * rank:4 * rank + 4])
            np.testing.assert_array_equal(r["ref"]["b"], tree["b"])
        # the port's sharded save is the reference's format: it restores there whole
        step, back = JCheckpointManager(d).restore(
            {k: jax.ShapeDtypeStruct(v.shape, jnp.float32) for k, v in tree.items()})
        assert step == 3
        for k in tree:
            np.testing.assert_array_equal(np.asarray(back[k]), tree[k])
        (one,) = run_ranks(workers.elastic_resume, 1, d, {k: v.shape for k, v in tree.items()},
                           device="cpu", timeout=120)
    assert one["mesh"] == {"data": 1, "model": 1}
    assert one["step"] == 3 and one["seek"] == 3
    for k in tree:
        np.testing.assert_array_equal(one["tree"][k], tree[k])


@pytest.mark.parametrize("healthy,mp,pods", [(16, 4, 1), (13, 4, 1), (16, 2, 2), (8, 8, 1)])
def test_plan_mesh_matches_the_reference(healthy, mp, pods):
    with tempfile.TemporaryDirectory() as d:
        got = ElasticController(mp, CheckpointManager(d), devices_total=16).plan_mesh(
            healthy, pods)
        # the reference's mesh math, without building its device mesh
        per_pod = healthy // pods
        data = per_pod // mp
        axes = ("pod", "data", "model") if pods > 1 else ("data", "model")
        shape = (pods, data, mp) if pods > 1 else (data, mp)
        assert got.shape == dict(zip(axes, shape))
        assert got.rank is None  # abstract until the restarted ranks bind it


def test_plan_mesh_raises_the_references_error():
    with tempfile.TemporaryDirectory() as d:
        with pytest.raises(RuntimeError) as want:
            JElasticController(4, JCheckpointManager(d), devices_total=8).plan_mesh(3)
        with pytest.raises(RuntimeError) as got:
            ElasticController(4, CheckpointManager(d), devices_total=8).plan_mesh(3)
        assert str(got.value) == str(want.value)
        assert ElasticController(4, CheckpointManager(d), 8).resume({}, {}) == (None, None)

"""The port's checkpoint manager on the CPU, and checkpoints crossing between
the two packages.

The disk format is the reference's: the same directory layout, manifest,
checksums and leaf key strings, so a ``TrainState`` saved by
``repro.ckpt.CheckpointManager`` restores in ``repro_torch.ckpt`` and the
other way round, values equal bit for bit (both sides hold float32 params
and an int32 step).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as jconfigs
from repro.ckpt import CheckpointManager as JManager
from repro.models import build_model as jbuild
from repro.optim import AdamW as JAdamW
from repro.train.step import TrainState as JTrainState
from repro_torch import configs as tconfigs
from repro_torch.ckpt import CheckpointManager
from repro_torch.models.common import tree_leaves
from repro_torch.models.convert import params_from_jax
from repro_torch.optim import AdamWState
from repro_torch.train.step import TrainState


def _tree():
    return {"layer": {"w": torch.arange(12.0).reshape(3, 4), "b": torch.ones((4,))},
            "step": torch.tensor(5, dtype=torch.int32)}


def _equal(a, b):
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_ckpt_roundtrip(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    tree = _tree()
    mgr.save(10, tree, extra={"note": "x"})
    step, restored = mgr.restore(tree)
    assert step == 10
    _equal(restored, tree)
    assert mgr.latest_manifest()["extra"] == {"note": "x"}


def test_ckpt_keeps_latest_and_gc(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _tree())
    assert mgr.steps() == [3, 4]


def test_ckpt_corruption_fallback(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=5)
    mgr.save(1, _tree())
    t2 = _tree()
    t2["layer"]["b"] += 1
    mgr.save(2, t2)
    (tmp_path / "step_000000002" / "arrays.npz").write_bytes(b"garbage")
    step, restored = mgr.restore(_tree())
    assert step == 1
    _equal(restored, _tree())
    # a flipped checksum is caught as well
    mgr.save(3, t2)
    man = tmp_path / "step_000000003" / "manifest.json"
    m = json.loads(man.read_text())
    m["checksums"]["layer/b"] = "0" * 16
    man.write_text(json.dumps(m))
    assert mgr.restore(_tree())[0] == 1


def test_ckpt_atomicity_tmp_never_visible(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(7, _tree())
    assert not any(p.name.startswith(".tmp") for p in tmp_path.iterdir())


def test_restore_places_leaves_as_like_and_skips_mismatches(tmp_path):
    mgr = CheckpointManager(tmp_path)
    tree = {"w": torch.randn(3, 4, generator=torch.Generator().manual_seed(0)),
            "h": torch.randn(2, generator=torch.Generator().manual_seed(1)).bfloat16()}
    mgr.save(1, tree)
    assert mgr.latest_manifest()["dtypes"] == {"h": "float32", "w": "float32"}
    meta = {k: torch.empty(v.shape, dtype=v.dtype, device="meta") for k, v in tree.items()}
    step, restored = mgr.restore(meta)
    assert step == 1 and restored["w"].device.type == "cpu"
    assert restored["h"].dtype == torch.bfloat16 and torch.equal(restored["h"], tree["h"])
    assert mgr.restore({"w": torch.empty(4, 3), "h": tree["h"]}) == (None, None)  # shape
    assert mgr.restore({"v": tree["w"]}) == (None, None)  # key
    assert mgr.restore(tree, step=2) == (None, None)


# ---------------------------------------------------------------------------
# across the packages: a TrainState either way
# ---------------------------------------------------------------------------
def _states():
    """The reference's gemma-2b reduced TrainState after one AdamW update
    (so mu, nu and the step are not zeros), and the port's from the same
    numbers."""
    cfg = jconfigs.get_config("gemma-2b").reduced()
    params = jbuild(cfg).init(jax.random.key(0))
    opt = JAdamW()
    grads = jax.tree.map(lambda p: 0.01 * jnp.ones_like(p), params)
    upd, ostate = opt.update(grads, opt.init(params), params, 1e-3)
    jstate = JTrainState(opt.apply(params, upd), ostate)
    np_state = jax.tree.map(np.asarray, jstate)
    tcfg = tconfigs.get_config("gemma-2b").reduced()
    tstate = TrainState(
        params_from_jax(np_state.params, tcfg, device="cpu"),
        AdamWState(step=torch.tensor(np_state.opt.step),
                   mu=params_from_jax(np_state.opt.mu, tcfg, device="cpu"),
                   nu=params_from_jax(np_state.opt.nu, tcfg, device="cpu")))
    return jstate, tstate


def test_train_state_keys_are_the_references(tmp_path):
    jstate, tstate = _states()
    JManager(tmp_path / "j").save(3, jstate)
    CheckpointManager(tmp_path / "t").save(3, tstate)
    jm = json.loads((tmp_path / "j" / "step_000000003" / "manifest.json").read_text())
    tm = json.loads((tmp_path / "t" / "step_000000003" / "manifest.json").read_text())
    assert tm == jm  # keys in order, shapes, dtypes and checksums
    assert {".params/embed", ".opt/.step", ".opt/.mu/embed", ".opt/.nu/layers/attn/wq"} <= set(
        tm["keys"])
    assert tm["shapes"][".opt/.step"] == [] and tm["dtypes"][".opt/.step"] == "int32"


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    jstate, tstate = _states()
    JManager(tmp_path).save(4, jstate)
    like = jax.tree.map(torch.zeros_like, tstate)
    step, restored = CheckpointManager(tmp_path).restore(like)
    assert step == 4 and isinstance(restored, TrainState)
    assert isinstance(restored.opt, AdamWState) and restored.opt.step.dtype == torch.int32
    _equal(restored, tstate)


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    jstate, tstate = _states()
    CheckpointManager(tmp_path).save(5, tstate)
    step, restored = JManager(tmp_path).restore(jax.eval_shape(lambda: jstate))
    assert step == 5
    for a, b in zip(jax.tree.leaves(restored), jax.tree.leaves(jstate)):
        assert a.dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_port_restore_rejects_an_incomplete_state(tmp_path):
    _, tstate = _states()
    CheckpointManager(tmp_path).save(1, tstate.params)  # params only: no .params/ prefix
    assert CheckpointManager(tmp_path).restore(tstate) == (None, None)
    assert CheckpointManager(tmp_path).restore(tstate.params)[0] == 1

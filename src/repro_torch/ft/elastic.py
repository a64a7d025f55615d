"""Elastic restart policy: dead/straggling workers -> new mesh -> resharded
resume.

Port of ``repro.ft.elastic``.  The coordinator logic a large deployment runs
around the train loop: on failure, shrink (or re-grow) the mesh to the
healthy device set, reshard the last good checkpoint onto it, and seek the
data pipeline to the checkpointed step.  The mesh math assumes whole-host
granularity and preserves the model axis (TP degree is a property of the
model, not the fleet).
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.ckpt import CheckpointManager, load_resharded
from repro_torch.launch.mesh import make_mesh_for


@dataclass
class ElasticController:
    model_parallel: int
    ckpt: CheckpointManager
    devices_total: int
    devices_per_host: int = 4

    def plan_mesh(self, healthy_devices: int, pods: int = 1):
        """Largest valid (pods, data, model) mesh within healthy devices
        (abstract: bind it on the restarted ranks)."""
        per_pod = healthy_devices // pods
        data = per_pod // self.model_parallel
        if data < 1:
            raise RuntimeError(
                f"not enough healthy devices ({healthy_devices}) for "
                f"model_parallel={self.model_parallel}"
            )
        usable = pods * data * self.model_parallel
        return make_mesh_for(usable, self.model_parallel, pods)

    def resume(self, like, new_shardings, pipeline=None):
        """Restore last-good checkpoint onto the new mesh; seek data."""
        step, tree = load_resharded(self.ckpt, like, new_shardings)
        if step is None:
            return None, None
        if pipeline is not None:
            pipeline.seek(step)
        return step, tree

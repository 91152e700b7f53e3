"""LearnerGroup: the scale-out wrapper around Learners.

The port of ``ray_tpu/rllib/core/learner_group.py``. Two modes:

- **local** (``num_remote_learners=0``): one Learner on this process's
  ranks. In a ``torch.distributed`` process group it runs on a mesh whose
  ``dp`` axis spans the group's world (each rank a block of the batch,
  gradients averaged over ``dp``), as the JAX group builds its mesh over
  every device it sees; without a group, on its own.
- **remote**: N learner actors on the port's runtime, each computing
  gradients on its batch shard; the group averages them row-weighted and
  every actor applies the same averaged update.

The port's one change of placement: a remote learner whose device is the
CUDA card leases a share of a card, so the runtime counts the card it
holds and a worker process of the lease is told its id. The share follows
from the learner count: a whole card each while the cluster has a card
for every learner, else each card split among as many learners as must
share it. The JAX package's learner actors ask for no accelerator.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import numpy as np

from ray_tpu_torch.rllib.core.learner import LearnerConfig
from ray_tpu_torch.rllib.core.rl_module import RLModuleSpec
from ray_tpu_torch.rllib.policy.torch_policy import tree_map


def learner_options(device, num_learners: int) -> Dict[str, Any]:
    """The actor options of each of ``num_learners`` learners on
    ``device``: none on the CPU; on the card, a whole card each, or
    ``1 / k`` of one where ``k`` learners must share each of the
    cluster's cards."""
    import torch
    if device is not None and torch.device(device).type != "cuda":
        return {}
    import ray_tpu_torch
    cards = int(ray_tpu_torch.cluster_resources().get("GPU", 0))
    if cards < 1:
        raise ValueError(
            f"{num_learners} learner(s) on the CUDA card, and the cluster "
            "has no GPU to lease; ask for device='cpu' or start the "
            "runtime with a GPU")
    return {"num_gpus": 1.0 / math.ceil(num_learners / cards)}


class _RemoteLearner:
    """Actor body: a built Learner driven over the runtime."""

    def __init__(self, learner_class, module_spec, config):
        self.learner = learner_class(module_spec, config).build()

    def compute_gradients(self, batch):
        return self.learner.compute_gradients(batch)

    def apply_gradients(self, grads):
        self.learner.apply_gradients(grads)
        return True

    def get_weights(self):
        return self.learner.get_weights()

    def set_weights(self, weights):
        self.learner.set_weights(weights)
        return True


class LearnerGroup:
    def __init__(self, learner_class, module_spec: RLModuleSpec,
                 config: Optional[LearnerConfig] = None,
                 num_remote_learners: int = 0, mesh=None):
        self.config = config or LearnerConfig()
        self._remote = num_remote_learners > 0
        if self._remote:
            import ray_tpu_torch
            actor_cls = ray_tpu_torch.remote(_RemoteLearner).options(
                **learner_options(self.config.device, num_remote_learners))
            self._learners = [
                actor_cls.remote(learner_class, module_spec, self.config)
                for _ in range(num_remote_learners)]
        else:
            import torch.distributed as dist
            if mesh is None and dist.is_initialized():
                from ray_tpu_torch.parallel.mesh import MeshConfig, build_mesh
                mesh = build_mesh(
                    MeshConfig(dp=dist.get_world_size(), fsdp=1),
                    self.config.device)
            self._learner = learner_class(module_spec, self.config,
                                          mesh=mesh).build()
            self.mesh = mesh

    @property
    def is_remote(self) -> bool:
        return self._remote

    def update(self, batch: Dict[str, Any]) -> Dict[str, float]:
        """One synchronous data-parallel update on the global batch."""
        if not self._remote:
            return self._learner.update(batch)
        import ray_tpu_torch
        size = len(next(iter(batch.values())))
        # Never hand a learner an empty shard (mean over zero rows is NaN
        # and would poison the averaged gradients); cover every row.
        n = min(len(self._learners), size)
        bounds = np.array_split(np.arange(size), n)
        shards = [
            {k: np.asarray(v)[idx[0]:idx[-1] + 1
                              ] for k, v in batch.items()}
            for idx in bounds]
        results = ray_tpu_torch.get([
            lr.compute_gradients.remote(s)
            for lr, s in zip(self._learners, shards)])
        # Shards can differ by one row: weight each gradient by its share
        # of the global batch so the average equals the full-batch grad.
        weights = np.asarray([len(idx) / size for idx in bounds],
                             np.float64)
        grads = tree_map(
            lambda *g: np.tensordot(weights, np.stack(g), axes=1).astype(
                np.asarray(g[0]).dtype),
            *[g for g, _ in results])
        ray_tpu_torch.get([lr.apply_gradients.remote(grads)
                           for lr in self._learners])
        metrics_list = [m for _, m in results]
        return {k: float(np.mean([m[k] for m in metrics_list]))
                for k in metrics_list[0]}

    def get_weights(self):
        if not self._remote:
            return self._learner.get_weights()
        import ray_tpu_torch
        return ray_tpu_torch.get(self._learners[0].get_weights.remote())

    def set_weights(self, weights) -> None:
        if not self._remote:
            self._learner.set_weights(weights)
            return
        import ray_tpu_torch
        ray_tpu_torch.get([lr.set_weights.remote(weights)
                           for lr in self._learners])

    def stop(self) -> None:
        if self._remote:
            import ray_tpu_torch
            for lr in self._learners:
                ray_tpu_torch.kill(lr)

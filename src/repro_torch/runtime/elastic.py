"""Elastic re-meshing: keep training when ranks fail (the counterpart of
``repro.runtime.elastic``).

Given the surviving rank count, pick the largest valid (data, model) mesh
that preserves the model-parallel degree (weights keep their model-axis
layout) and shrinks the data axis; the checkpoint manager then re-shards
state onto it (``CheckpointManager.restore(shardings=)``).
"""
from __future__ import annotations

from repro_torch.sharding import Mesh, make_mesh


def plan_elastic_mesh(n_devices: int, *, model_parallel: int = 16,
                      prefer_pods: bool = True):
    """Returns (shape, axis_names) for the largest usable mesh."""
    if n_devices < model_parallel:
        raise ValueError(f"need >= {model_parallel} devices for TP={model_parallel}")
    usable = (n_devices // model_parallel) * model_parallel
    data = usable // model_parallel
    # factor a pod axis back out when the data axis is big enough
    if prefer_pods and data % 16 == 0 and data > 16:
        return (data // 16, 16, model_parallel), ("pod", "data", "model")
    return (data, model_parallel), ("data", "model")


def make_elastic_mesh(n_devices: int, *, model_parallel: int = 16,
                      device=None) -> Mesh | None:
    """The planned mesh over the first ``usable`` ranks of the world; a rank
    past them gets ``None``."""
    shape, names = plan_elastic_mesh(n_devices, model_parallel=model_parallel)
    return make_mesh(shape, names, device=device)

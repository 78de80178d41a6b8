"""Mesh construction (the counterpart of ``repro.launch.mesh``).

Functions, not module-level constants, so importing this module never
touches ``torch.distributed``.  The backend follows the device: NCCL for a
CUDA mesh, gloo for a CPU one (``sharding.make_mesh`` checks it).
"""
from __future__ import annotations

import torch.distributed as dist

from repro_torch.sharding import Mesh, counting_mesh, make_mesh


def _world() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def make_production_mesh(*, multi_pod: bool = False, device=None,
                         counting: bool = False) -> Mesh:
    """(16, 16) ``("data", "model")``, or (2, 16, 16) with ``"pod"`` in
    front; raises unless the world has exactly that many ranks, as
    ``jax.make_mesh`` does for its devices.  ``device`` is this rank's card
    (default: the current CUDA device; set it per rank first).
    ``counting=True``: rank 0 of the dry run's world of that many ranks
    (``sharding.counting_mesh``, on ``device``, default the CPU), with no
    process group."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if counting:
        return counting_mesh(shape, axes, device=device or "cpu")
    n, world = 16 * 16 * (2 if multi_pod else 1), _world()
    if world != n:
        raise ValueError(f"the production mesh {shape} needs {n} ranks; "
                         f"this world has {world}")
    return make_mesh(shape, axes, device=device)


def make_host_mesh(device=None) -> Mesh:
    """A 1x1 ``("data", "model")`` mesh on ``device`` (default: the CUDA
    device; ``device="cpu"`` for the CPU)."""
    return make_mesh((1, 1), ("data", "model"), device=device)

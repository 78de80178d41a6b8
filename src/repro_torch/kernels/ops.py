"""The port's kernel inventory and its launch counts.

Each entry is a hand-written CUDA kernel's public wrapper, taken from
``kernels/registry.py``'s ``REGISTRY`` (the reference's nine dispatch sites,
``wkv6_bwd``, the backward of ``wkv6``, which the reference leaves to XLA,
``fail_prob_rows``, ``fail_prob``'s row sums without the grid, and
``adamw``, the train step's update), and ``grad_sq_norm``, the global norm
whose kernels share ``adamw``'s library and have no launch space.  A
wrapper dispatches by its tensors' device (CPU -> the plain PyTorch
version, CUDA -> the kernel at the launch ``kernels/tune.py`` picks, or it
raises) and carries ``launches``, a count of kernel launches that nothing
but the launch itself increments (a tuner's sweep counts nowhere).
There is no backend switch and no fallback: a CUDA tensor runs the kernel.
"""
from __future__ import annotations

from repro_torch.kernels.adamw import grad_sq_norm
from repro_torch.kernels.registry import REGISTRY

KERNELS = {name: spec.kernel for name, spec in REGISTRY.items()}
#: every wrapper that counts launches: the registry's and grad_sq_norm
COUNTED = {**KERNELS, "grad_sq_norm": grad_sq_norm}


def reset_launches() -> None:
    """Set every kernel's launch count to 0, and its routes' where it has
    more than one kernel (``bank_sched``)."""
    for fn in COUNTED.values():
        fn.launches = 0
        if hasattr(fn, "route_launches"):
            fn.route_launches = dict.fromkeys(fn.route_launches, 0)


def launch_counts() -> dict[str, int]:
    """{wrapper name: launches since the last reset}."""
    return {name: fn.launches for name, fn in COUNTED.items()}

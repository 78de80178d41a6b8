"""The port's kernel inventory and its launch counts.

``KERNELS`` holds each hand-written CUDA kernel's public wrapper under the
reference's dispatch-site name, in the order of ``repro/kernels/registry.py``
(the reference's nine dispatch sites), then ``wkv6_bwd``, the backward of
``wkv6``, which the reference leaves to XLA, ``fail_prob_rows``,
``fail_prob``'s row sums without the grid, and ``adamw``, the train step's
update.  ``COUNTED`` adds ``grad_sq_norm``, the global norm whose kernels
share ``adamw``'s library.  A wrapper dispatches by its tensors' device (CPU
-> the plain PyTorch version, fake tensors -> outputs of the right shapes
where the dry run takes the kernel, CUDA -> the kernel, or it raises) and
carries ``launches``, a count of its kernel launches.  A launch increments
it, and so does a replay of a CUDA graph that holds launches:
``launch/steps``' train step counts what each graph captured
(``launch_snapshot``), takes it back from the counters after the capture,
which launches nothing, and adds it again at every replay
(``add_launches``).  There is no backend switch and no fallback: a CUDA
tensor runs the kernel, at the launch constants of its ``csrc/*.cu``
source.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.adamw import adamw_update, grad_sq_norm
from repro_torch.kernels.bank_sched import memsim_walk
from repro_torch.kernels.bit_signature import bit_signature
from repro_torch.kernels.fail_prob import fail_prob, fail_prob_op, fail_prob_rows
from repro_torch.kernels.rc_transient import rc_transient
from repro_torch.kernels.secded import encode_checks, syndrome
from repro_torch.kernels.shuffle import apply_shuffle
from repro_torch.kernels.wkv6 import wkv6, wkv6_bwd

KERNELS = {
    "secded_encode": encode_checks,
    "secded_syndrome": syndrome,
    "fail_prob": fail_prob,
    "fail_prob_op": fail_prob_op,
    "bit_signature": bit_signature,
    "bank_sched": memsim_walk,
    "diva_shuffle": apply_shuffle,
    "rc_transient": rc_transient,
    "wkv6": wkv6,
    "wkv6_bwd": wkv6_bwd,
    "fail_prob_rows": fail_prob_rows,
    "adamw": adamw_update,
}
#: every wrapper that counts launches: the kernels' and grad_sq_norm
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


def launch_snapshot() -> dict:
    """Every launch counter: ``{(wrapper name, None): launches}`` and, where
    a wrapper also counts its routes (``bank_sched``), ``{(wrapper name,
    route): launches}``."""
    out = {}
    for name, fn in COUNTED.items():
        out[name, None] = fn.launches
        for route, n in getattr(fn, "route_launches", {}).items():
            out[name, route] = n
    return out


def add_launches(counts: dict) -> None:
    """Add ``counts`` (keyed as ``launch_snapshot``'s; negative takes away)
    to the counters."""
    for (name, route), n in counts.items():
        fn = COUNTED[name]
        if route is None:
            fn.launches += n
        else:
            fn.route_launches[route] += n


def same_bits(a, b) -> bool:
    """Two outputs (tensors, or tuples/lists/dicts of them, or None) equal
    bit for bit: the same dtypes, shapes, devices and bytes."""
    if isinstance(a, torch.Tensor):
        return (isinstance(b, torch.Tensor) and a.dtype == b.dtype
                and a.shape == b.shape and a.device == b.device
                and torch.equal(a.contiguous().reshape(-1).view(torch.uint8),
                                b.contiguous().reshape(-1).view(torch.uint8)))
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() \
            and all(same_bits(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return isinstance(b, (tuple, list)) and len(a) == len(b) \
            and all(same_bits(x, y) for x, y in zip(a, b))
    return a is None and b is None

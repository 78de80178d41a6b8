"""The port's kernel inventory and its launch counts.

Each entry is a hand-written CUDA kernel's public wrapper: it dispatches by
its tensors' device (CPU -> the plain PyTorch version, CUDA -> the kernel, or
it raises) and carries ``launches``, a count of kernel launches that nothing
but the launch itself increments.  There is no backend switch and no
fallback: a CUDA tensor runs the kernel.  Each of the reference's nine
Pallas kernels has its entry here, and so has ``wkv6_bwd``, the backward of
``wkv6`` (the reference differentiates its scan with XLA instead).
"""
from __future__ import annotations

from repro_torch.kernels.bank_sched import memsim_walk
from repro_torch.kernels.bit_signature import bit_signature
from repro_torch.kernels.fail_prob import fail_prob, fail_prob_op
from repro_torch.kernels.rc_transient import rc_transient
from repro_torch.kernels.secded import encode_checks, syndrome
from repro_torch.kernels.shuffle import apply_shuffle
from repro_torch.kernels.wkv6 import wkv6, wkv6_bwd

KERNELS = {"fail_prob": fail_prob, "secded_encode": encode_checks,
           "secded_syndrome": syndrome, "diva_shuffle": apply_shuffle,
           "bank_sched": memsim_walk, "fail_prob_op": fail_prob_op,
           "bit_signature": bit_signature, "rc_transient": rc_transient,
           "wkv6": wkv6, "wkv6_bwd": wkv6_bwd}


def reset_launches() -> None:
    """Set every kernel's launch count to 0, and its routes' where it has
    more than one kernel (``bank_sched``)."""
    for fn in KERNELS.values():
        fn.launches = 0
        if hasattr(fn, "route_launches"):
            fn.route_launches = dict.fromkeys(fn.route_launches, 0)


def launch_counts() -> dict[str, int]:
    """{kernel name: launches since the last reset}."""
    return {name: fn.launches for name, fn in KERNELS.items()}

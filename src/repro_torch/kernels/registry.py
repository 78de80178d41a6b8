"""Declarative kernel registry: the port's twelve hand-written kernels as data.

The counterpart of ``repro/kernels/registry.py``.  Each :class:`KernelSpec`
names one kernel under the reference's dispatch-site name (plus
``wkv6_bwd``, the backward the reference leaves to XLA,
``fail_prob_rows``, ``fail_prob``'s grid summed on chip, and ``adamw``, the
train step's AdamW update, which the reference leaves to XLA), its public wrapper,
its plain PyTorch version, the launch space the tuner (``kernels/tune.py``)
may sweep, and the shape bucket a call's winner is cached under.

A launch setting is a dict of the kernel's launch constants (``{"rows":
64}``, ``{"row_tile": 16}``, ``{"chunk": 8}``), each a template parameter of
its CUDA source that the wrapper passes through the C entry point.  The
FIRST entry of ``launch_space`` is ``{}``: the constants in ``defaults``,
the launch every kernel made before it had a space, so an untuned call
launches exactly that.  A setting only changes how the work is cut into
blocks and threads, never an operation or its order: every setting of a
space gives the default's output bit for bit (``chip_smoke.py`` phase 32
checks each on the card).  Settings that would not are left out, each with
its reason beside the spec.

``bucket`` maps a call's ``(args, kw)`` to the extent the tuner rounds to a
power of two: the reference's bucket wherever the arguments correspond.
"""
from __future__ import annotations

import sys
from dataclasses import dataclass, field
from typing import Any, Callable

from repro_torch.kernels.adamw import adamw_update
from repro_torch.kernels.bank_sched import memsim_walk
from repro_torch.kernels.bit_signature import bit_signature
from repro_torch.kernels.fail_prob import fail_prob, fail_prob_op, fail_prob_rows
from repro_torch.kernels.rc_transient import rc_transient
from repro_torch.kernels.secded import encode_checks, syndrome
from repro_torch.kernels.shuffle import apply_shuffle
from repro_torch.kernels.wkv6 import CHUNK_BWD, wkv6, wkv6_bwd


def _lead_dim(args, kw) -> int:
    """Default shape bucket: the leading axis of the first tensor."""
    return int(args[0].shape[0])


def _fail_prob_bucket(args, kw) -> int:
    # (row_src (R,) or (D, R), d_mat, coeffs): R, as the reference's per-DIMM
    # bucket; the DIMM axis is not in it
    return int(args[0].shape[-1])


def _walks_bucket(args, kw) -> int:
    # (traces (W, n, 4), tc (T, B, 6)): the T*W walks of one launch.  The
    # reference buckets one scheduler step's queue; the port's kernel walks
    # whole traces, so it has no counterpart
    return int(args[1].shape[0] * args[0].shape[0])


def _wkv6_bucket(args, kw) -> int:
    # r (B, S, H, dh): B*H*S, as the reference's
    r = args[0]
    return int(r.shape[0] * r.shape[2] * r.shape[1])


def _numel_bucket(args, kw) -> int:
    # the leaves of one update: their elements together
    return sum(int(t.numel()) for t in args)


@dataclass(frozen=True, eq=False)
class KernelSpec:
    """One kernel: its wrapper, plain version, launch space and bucket.

    ``kernel`` takes ``launch=`` (a setting of ``launch_space``, or None to
    ask the tuner); ``ref`` names its plain version on the wrapper's module.
    """
    name: str
    kernel: Callable
    ref: str
    defaults: dict[str, int]
    launch_space: tuple[dict[str, int], ...] = ({},)
    bucket: Callable = _lead_dim
    _full: tuple = field(init=False, repr=False)

    def __post_init__(self):
        if self.launch_space[0] != {}:
            raise ValueError(f"{self.name}: the first launch setting must be {{}}")
        object.__setattr__(self, "_full", tuple(
            {**self.defaults, **s} for s in self.launch_space))

    @property
    def plain(self) -> Callable:
        """The plain PyTorch version, looked up on the wrapper's module at
        CALL time, so a monkeypatched ``*_ref`` is what the CPU route runs."""
        return getattr(sys.modules[self.kernel.__module__], self.ref)

    def setting(self, launch: dict[str, Any] | None) -> dict[str, int]:
        """The full launch constants of ``launch`` (None or ``{}``: the
        defaults; a partial dict overrides them).  Raises ValueError for a
        key the kernel does not have or a setting outside its space."""
        launch = {} if launch is None else dict(launch)
        unknown = set(launch) - set(self.defaults)
        if unknown:
            raise ValueError(f"{self.name} has no launch constant "
                             f"{sorted(unknown)}; it has {sorted(self.defaults)}")
        full = {**self.defaults, **launch}
        if full not in self._full:
            raise ValueError(f"{self.name}: launch {launch} is outside its space "
                             f"{list(self.launch_space)} (defaults {self.defaults})")
        return full


REGISTRY: dict[str, KernelSpec] = {s.name: s for s in (
    # codewords a block.  The staged tile is rows x 73 int32 of static shared
    # memory (37 KB at 128): more rows need dynamic shared memory
    KernelSpec("secded_encode", encode_checks, "encode_checks_ref",
               defaults={"rows": 128},
               launch_space=({}, {"rows": 32}, {"rows": 64})),
    KernelSpec("secded_syndrome", syndrome, "syndrome_ref",
               defaults={"rows": 128},
               launch_space=({}, {"rows": 32}, {"rows": 64})),
    # rows a block and the cap on threads a block (4 columns a thread); the
    # row tile stays <= 32, the smallest block (one warp), which stages it
    KernelSpec("fail_prob", fail_prob, "fail_prob_ref",
               defaults={"row_tile": 32, "threads": 128},
               launch_space=({}, {"row_tile": 16}, {"threads": 64},
                             {"threads": 256}),
               bucket=_fail_prob_bucket),
    KernelSpec("fail_prob_op", fail_prob_op, "fail_prob_op_ref",
               defaults={"row_tile": 32, "threads": 128},
               launch_space=({}, {"row_tile": 16}, {"threads": 64},
                             {"threads": 256}),
               bucket=_fail_prob_bucket),
    # threads a block: a warp a count row, whatever the block
    KernelSpec("bit_signature", bit_signature, "bit_signature_ref",
               defaults={"threads": 256},
               launch_space=({}, {"threads": 128}, {"threads": 512},
                             {"threads": 1024})),
    # warps a block of the fast walk (each warp walks its own traces); the
    # general walk, one warp a block, takes the default alone
    KernelSpec("bank_sched", memsim_walk, "memsim_walk_ref",
               defaults={"warps": 1},
               launch_space=({}, {"warps": 2}, {"warps": 4}),
               bucket=_walks_bucket),
    # bursts a tile and persistent blocks an SM (the tile is static shared
    # memory: 16 bursts are 36 KB)
    KernelSpec("diva_shuffle", apply_shuffle, "apply_shuffle_ref",
               defaults={"tile_rows": 8, "blocks_per_sm": 8},
               launch_space=({}, {"tile_rows": 4, "blocks_per_sm": 16},
                             {"tile_rows": 16, "blocks_per_sm": 4},
                             {"blocks_per_sm": 4})),
    # threads a block: a thread a cell, warps of 32 consecutive cells
    KernelSpec("rc_transient", rc_transient, "rc_transient_ref",
               defaults={"threads": 128},
               launch_space=({}, {"threads": 64}, {"threads": 256},
                             {"threads": 32})),
    # steps a chunk (kT).  Every step's operations and their order are the
    # same in any chunk, so y and the state keep their bits; the chunk must
    # stage whole steps (kT * dh a multiple of the block at every dh: kT a
    # multiple of 4).  16 and 24 are left out: at dh = 64 their staged steps
    # and partial sums (49,280 and 73,920 bytes) pass the 48 KB of static
    # shared memory
    KernelSpec("wkv6", wkv6, "wkv6_ref",
               defaults={"chunk": 12},
               launch_space=({}, {"chunk": 8}, {"chunk": 4}),
               bucket=_wkv6_bucket),
    # steps a saved chunk (kC): the default alone.  du sums each (b, h)'s
    # steps by their residue mod kC and then the residues in order, so
    # another kC adds du's terms in another order (other bits); and at
    # dh = 64 kC = 4 stages fewer row values (4 x 32) than the block has
    # threads (256).  The cluster split (Split<dh>) orders the partial sums
    # of dv and stays fixed too
    KernelSpec("wkv6_bwd", wkv6_bwd, "wkv6_bwd_ref",
               defaults={"chunk": CHUNK_BWD},
               bucket=_wkv6_bucket),
    # rows a block and the cap on threads a block, as fail_prob's.  Each
    # row's sum has an order fixed by its cells' mats and columns alone
    # (csrc/fail_prob.cu), so any tile and any count of threads up to the
    # 128 column slots keeps it; 256 threads would leave threads without a
    # slot and is left out.  A block walks every mat, so small tiles keep
    # the SMs evenly loaded: 8 rows by default (96 FULL DIMMs on the H100:
    # 1.15 ms against 1.23 at 32 rows)
    KernelSpec("fail_prob_rows", fail_prob_rows, "fail_prob_rows_ref",
               defaults={"row_tile": 8, "threads": 128},
               launch_space=({}, {"row_tile": 4}, {"row_tile": 16},
                             {"row_tile": 32, "threads": 64}),
               bucket=_fail_prob_bucket),
    # threads a block (a block updates threads x 32 elements of one leaf):
    # the default alone, the one block the kernel is built for.  128 and 512
    # give the same bits (elementwise), but at rwkv6-1.6b's leaves they ran
    # within 1% of 256 on an H100 (14.7-15.1 ms), and a sweep holds two more
    # copies of the new state beside the old: 77 GB of its 80 at the first
    # step with three settings.  The norm's kernels (grad_sq_norm, same module) take
    # no setting: another block would sum the squares in another order
    KernelSpec("adamw", adamw_update, "adamw_update_ref",
               defaults={"threads": 256},
               bucket=_numel_bucket),
)}

#: the reference's nine dispatch-site names, in its order, then wkv6_bwd,
#: fail_prob_rows and adamw
KERNEL_NAMES: tuple[str, ...] = tuple(REGISTRY)

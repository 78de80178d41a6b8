"""Roofline bookkeeping on the NVIDIA H100: the three roofline terms of a
step from its counted FLOPs, bytes and collectives (the counterpart of
``repro.launch.roofline``, re-targeted from the reference's TPU v5e).

Peaks of one H100 SXM5 (the NVIDIA H100 Tensor Core GPU datasheet; dense
rates, no sparsity, at its full 700 W power limit).  The compute term
divides each op's FLOPs by the peak of its dtype: bfloat16 and float16
products run on the tensor cores, float32 ones (the port's ``wr`` router,
its attention scores, the ``wkv6`` kernels) in full float32 on the CUDA
cores, 15 times slower (``torch.backends.cuda.matmul.allow_tf32`` is off).
The memory term divides the counted bytes by the HBM3 rate.  The collective
term divides each axis's operand bytes by the rate of that axis's links:
NVLink within a node of 8 GPUs, the inter-node network (one 400 Gb/s NDR
NIC per GPU, as in a DGX H100) across nodes.  An axis whose every group of
ranks lies within one run of 8 consecutive ranks (a node, ranks laid out
row-major) is an NVLink axis; any other axis is an inter-node one.  On the
production meshes (16, 16) and (2, 16, 16) every axis spans nodes.

``collective_bytes`` is the counterpart of the reference's HLO parse: the
port has no HLO, so it reads the tally that ``sharding``'s collectives keep
(operand bytes a call, as the reference sums operand sizes).
"""
from __future__ import annotations

from itertools import product
from math import prod

from repro_torch.tree import tree_leaves, tree_map_with_path

# the NVIDIA H100 Tensor Core GPU datasheet, SXM5
PEAK_FLOPS_BY_DTYPE = {
    "bfloat16": 989.4e12,   # tensor cores, dense
    "float16": 989.4e12,    # tensor cores, dense
    "float32": 66.9e12,     # CUDA cores, without TF32
}
PEAK_FLOPS = PEAK_FLOPS_BY_DTYPE["bfloat16"]
HBM_BW = 3.35e12            # B/s, HBM3
NVLINK_BW = 450e9           # B/s each way (NVLink 4: 900 GB/s a GPU in all)
INTER_NODE_BW = 50e9        # B/s each way: 400 Gb/s NDR, one NIC a GPU (DGX H100)
NODE_GPUS = 8
HBM_BYTES = 80e9            # a card's memory

KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute")


def collective_bytes(tally: dict) -> dict:
    """The reference's record of collectives from ``sharding.COLLECTIVES``
    (``{(kind, axis): [calls, bytes]}``): operand bytes and counts by kind,
    their total, and the bytes by axis."""
    out = dict.fromkeys(KINDS, 0)
    counts = dict.fromkeys(KINDS, 0)
    by_axis: dict = {}
    for (kind, axis), (n, nbytes) in tally.items():
        out[kind] += nbytes
        counts[kind] += n
        by_axis[axis] = by_axis.get(axis, 0) + nbytes
    out["total"] = sum(out[k] for k in KINDS)
    out["counts"] = counts
    out["by_axis"] = by_axis
    return out


def axis_links(shape, names) -> dict:
    """{axis: "nvlink" | "inter-node"} for a row-major mesh of ``shape``:
    NVLink where every group of the axis stays within one node of
    ``NODE_GPUS`` consecutive ranks."""
    strides = [prod(shape[i + 1:]) for i in range(len(shape))]
    out = {}
    for i, name in enumerate(names):
        others = [range(s) if j != i else range(1) for j, s in enumerate(shape)]
        within = True
        for base in product(*others):
            r0 = sum(c * st for c, st in zip(base, strides))
            nodes = {(r0 + k * strides[i]) // NODE_GPUS for k in range(shape[i])}
            if len(nodes) > 1:
                within = False
                break
        out[name] = "nvlink" if within else "inter-node"
    return out


def roofline_terms(flops_by_dtype: dict, n_bytes: float, coll: dict, links: dict) -> dict:
    """The three terms in seconds for one rank's counts: FLOPs by dtype over
    each dtype's peak, bytes over the HBM rate, each axis's collective bytes
    over its link's rate."""
    t_compute = sum(n / PEAK_FLOPS_BY_DTYPE[dt] for dt, n in flops_by_dtype.items())
    t_memory = n_bytes / HBM_BW
    t_coll = sum(nbytes / (NVLINK_BW if links.get(axis) == "nvlink" else INTER_NODE_BW)
                 for axis, nbytes in coll.get("by_axis", {}).items())
    dom = max((t_compute, "compute"), (t_memory, "memory"), (t_coll, "collective"))[1]
    return {"t_compute_s": t_compute, "t_memory_s": t_memory, "t_collective_s": t_coll,
            "dominant": dom,
            "roofline_frac": t_compute / max(t_compute, t_memory, t_coll, 1e-30)}


def _leaves_with_path(tree) -> list:
    return tree_leaves(tree_map_with_path(lambda path, leaf: (path, leaf), tree))


def param_count(params) -> int:
    return sum(leaf.numel() for _, leaf in _leaves_with_path(params))


def active_param_count(params, cfg) -> int:
    """MoE-aware: expert tensors (``wei``, ``weg``, ``weo``) count at k/E of
    their size."""
    frac = cfg.experts_per_token / cfg.n_experts if cfg.n_experts else 1.0
    total = 0
    for path, leaf in _leaves_with_path(params):
        n = leaf.numel()
        if any(k in ("wei", "weg", "weo") for k in path):
            n = int(n * frac)
        total += n
    return total


def tokens_per_step(cfg, shape) -> int:
    if shape.kind == "train":
        return shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return shape.global_batch * shape.seq_len
    return shape.global_batch  # decode: one new token per sequence

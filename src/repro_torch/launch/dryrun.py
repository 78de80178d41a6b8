"""The dry run on the H100 production meshes: trace rank 0's program of every
(arch x shape x mesh) cell on fake tensors and record its roofline inputs
(the counterpart of ``repro.launch.dryrun``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun            # all 80 cells
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-0.5b --shape train_4k --mesh single

How it traces.  No world is started and nothing is allocated: rank 0's
``Mesh`` of the (16, 16) or (2, 16, 16) production mesh is a counting mesh
(``launch.mesh.make_production_mesh(counting=True)``: each axis a
``sharding.CountingGroup``, collectives that move no data and count their
operand bytes), the state, the cache and the batch are fake tensors
(``launch.steps.abstract_state`` / ``abstract_cache`` / ``input_specs``) on
the CPU, cut to the rank's shards by the same ``shard_tree`` a real rank
uses, and the rank's step (``make_sharded_train_step``,
``make_sharded_prefill_step``, ``make_sharded_decode_step``) runs on them
under ``FakeTensorMode`` and a ``counting.WorkCounter``: device ops, FLOPs
by dtype (``torch.utils.flop_counter``'s registry, and the ``wkv6`` /
``wkv6_bwd`` kernels' formulas, which their wrappers report for every call
the card would launch), bytes (each eager op's inputs and outputs: the port
fuses nothing), the collectives by kind and axis, and the live memory.  A
Mamba scan counts all of its steps (``models/scan_utils``).  The program
traced is the card's: the fake tensors lie on the CPU (this CPU build of
PyTorch cannot make fake CUDA tensors), but every op is the one the card
runs, and the kernels count as kernels.  Since no process group exists, one
process runs both meshes.

Memory (``memory``): the peak of the live storages of one rank, each
rounded up to the CUDA caching allocator's 512-byte blocks, split into the
state at rest (the rank's shards of the parameters, or of the whole train
state), the cache (the rank's, in and out), the batch (the rank's shard),
the gathered copy of the parameters, the activations (train: allocated
before the backward began, live at the peak) and the temporaries (the
rest).  The reference's keys: ``argument_size_in_bytes`` the state, cache
and batch shard the step is given; ``output_size_in_bytes`` what it
returns; ``alias_size_in_bytes`` the outputs that are inputs' storages;
``temp_size_in_bytes`` the peak beyond arguments and outputs;
``generated_code_size_in_bytes`` 0 (no compiled program).

Options (``--opt``): ``kvq8`` (the int8 KV cache), ``infer-tp`` (prefill
and decode keep the parameters split over "model" only: the state at rest
changes, the gathered copy does not), ``a2a`` (the all-to-all MoE path,
``REPRO_MOE_A2A=1`` for the cell), ``cap10`` (MoE capacity factor 1.0),
``remat-none`` (``cfg.remat``).  The reference's ``seq-shard``, ``--scan``
and ``--save-hlo`` have no counterpart: the port keeps no XLA layout hints,
has no layer-scan switch and no HLO, and they raise.

Records go to ``experiments/dryrun_torch/{single,multi}[_tag]/``;
``launch/roofline_report.py`` renders them.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from contextlib import contextmanager
from pathlib import Path

import torch
from torch.utils._pytree import tree_leaves

from repro_torch import sharding as shd
from repro_torch.configs.base import SHAPES, ShapeConfig, shape_applicable
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.counting import WorkCounter, fake_mode
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.roofline import (active_param_count, axis_links, collective_bytes,
                                         param_count, roofline_terms, tokens_per_step)

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"
OPTS = ("kvq8", "infer-tp", "a2a", "cap10", "remat-none")
NOT_PORTED = {
    "seq-shard": "the port keeps no XLA layout hints (sharding.py)",
    "scan": "the port has no layer-scan switch: its layers are a Python loop",
    "save-hlo": "the port runs eagerly and has no HLO",
}
LAYOUT = ("ranks row-major over the mesh, nodes of 8 consecutive ranks joined by "
          "NVLink, nodes joined by 400 Gb/s NDR (one NIC a GPU)")
CACHE_LAYOUT = ("the rank's batch shard over the batch axes, whole heads and "
                "sequence (the same on every rank of \"model\")")
MEMORY_NOTES = {
    "peak_bytes": "the most bytes of live storages at once, each rounded up to 512",
    "state": "the rank's shards of the train state (train) or of the parameters",
    "cache": "the rank's cache, given and returned",
    "batch": "the rank's batch shard",
    "gathered": "the parameters gathered whole for compute (experts split over "
                "\"model\" stay split)",
    "activations": "train: allocated before the backward began, live at the peak",
    "temporaries": "everything else live at the peak",
    "argument_size_in_bytes": "state + cache + batch shard given to the step",
    "output_size_in_bytes": "what the step returns",
    "alias_size_in_bytes": "returned storages that are arguments' (in place)",
    "temp_size_in_bytes": "peak - (arguments + outputs - aliases), at least 0",
    "generated_code_size_in_bytes": "0: no compiled program",
}


def check_opts(opts) -> None:
    for o in opts:
        if o in NOT_PORTED:
            raise ValueError(f"--opt {o} has no counterpart in the port: {NOT_PORTED[o]}")
        if o not in OPTS:
            raise ValueError(f"unknown --opt {o!r}; known: {OPTS}")


def configure(arch: str, opts=()):
    """``arch``'s config with the options applied."""
    check_opts(opts)
    cfg = get_config(arch)
    if "kvq8" in opts:
        cfg = cfg.replace(kv_quant=True)
    if "cap10" in opts:
        cfg = cfg.replace(capacity_factor=1.0)
    if "remat-none" in opts:
        cfg = cfg.replace(remat="none")
    return cfg


@contextmanager
def _moe_path(a2a: bool):
    prev = os.environ.get("REPRO_MOE_A2A")
    os.environ["REPRO_MOE_A2A"] = "1" if a2a else "0"
    try:
        yield
    finally:
        if prev is None:
            os.environ.pop("REPRO_MOE_A2A")
        else:
            os.environ["REPRO_MOE_A2A"] = prev


def rank_program(cfg, shape: ShapeConfig, mesh, state, *, cache=None,
                 fsdp_axes=("data",)):
    """The step of ``shape.kind`` on ``mesh`` and this rank's arguments but
    the batch: ``(step, args)``, called as ``step(*args, batch)``.
    ``state`` is the whole train state (``{"params", ...}``; prefill and
    decode read its parameters), ``cache`` the whole cache (decode)."""
    if shape.kind == "train":
        sh = steps_mod.state_shardings(state, mesh, fsdp_axes)
        return steps_mod.make_sharded_train_step(cfg, mesh, sh), (shd.shard_tree(state, sh),)
    psh = shd.param_shardings(state["params"], mesh, fsdp_axes)
    params = shd.shard_tree(state["params"], psh)
    if shape.kind == "prefill":
        return steps_mod.make_sharded_prefill_step(cfg, mesh, psh, max_seq=shape.seq_len), \
            (params,)
    csh = steps_mod.cache_rank_shardings(cache, mesh)
    return steps_mod.make_sharded_decode_step(cfg, mesh, psh), \
        (params, shd.shard_tree(cache, csh))


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _batch_shard_bytes(batch, mesh) -> int:
    bax = shd.entry_axes(shd._bax(mesh, len(batch["tokens"])))
    n = 1
    for a in bax:
        n *= mesh.shape[a]
    return _nbytes(batch) // n


def trace(cfg, shape: ShapeConfig, mesh, *, fsdp_axes=("data",)) -> dict:
    """Rank ``mesh.coords``'s step of ``cfg`` at ``shape`` on fake tensors:
    its counts (``WorkCounter.summary``), collectives, memory and
    ``trace_s``."""
    t0 = time.time()
    with fake_mode():
        state = steps_mod.abstract_state(cfg)
        cache = steps_mod.abstract_cache(cfg, shape) if shape.kind == "decode" else None
        batch = steps_mod.input_specs(cfg, shape)
        step, args = rank_program(cfg, shape, mesh, state, cache=cache, fsdp_axes=fsdp_axes)
        del state, cache
        shd.reset_collectives()
        batch_bytes = _batch_shard_bytes(batch, mesh)
        with WorkCounter(split_activations=shape.kind == "train") as counter:
            counter.adopt(args[0], "state")
            if shape.kind == "decode":
                counter.adopt(args[1], "cache")
            counter.hold_bytes(batch_bytes, "batch")
            out = step(*args, batch)
            if shape.kind != "train":
                counter.retag(out[1], "cache")
            held = {id(t.untyped_storage()) for t in tree_leaves(args)}
            outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
            alias = sum(counter.storage_bytes(t) for t in outs
                        if id(t.untyped_storage()) in held)
            argument = counter.storage_bytes(args) + batch_bytes
            output = counter.storage_bytes(outs)
            peak, parts = counter.peak, counter.peak_parts()
        coll = collective_bytes(shd.COLLECTIVES)
    memory = {"generated_code_size_in_bytes": 0, "argument_size_in_bytes": argument,
              "output_size_in_bytes": output, "alias_size_in_bytes": alias,
              "temp_size_in_bytes": max(0, peak - (argument + output - alias)),
              "peak_bytes": peak, "peak_parts": parts}
    return {**counter.summary(), "collectives": coll, "memory": memory,
            "trace_s": round(time.time() - t0, 2)}


def run_cell(arch: str, shape_name: str, multi_pod: bool, *, opts: tuple = ()) -> dict:
    """One cell's record: ``skip`` where the shape does not apply (the
    port's ``shape_applicable``), else ``ok`` with the rank's counts, memory
    and the three H100 roofline terms (raises on a fault; ``main`` records
    it as ``fail``)."""
    cfg = configure(arch, opts)
    fsdp = () if "infer-tp" in opts else ("data",)
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    mesh_name = "multi" if multi_pod else "single"
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name, "status": "skip",
           "reason": why}
    if not ok:
        return rec
    mesh = make_production_mesh(multi_pod=multi_pod, counting=True)
    with _moe_path("a2a" in opts):
        got = trace(cfg, shape, mesh, fsdp_axes=fsdp)
    n_chips = mesh.size
    links = axis_links(mesh.axis_sizes, mesh.axis_names)
    with fake_mode():
        params = steps_mod.abstract_state(cfg)["params"]
        n_params = param_count(params)
        n_active = active_param_count(params, cfg)
    toks = tokens_per_step(cfg, shape)
    rec.update({
        "status": "ok",
        "reason": "",
        "opts": list(opts),
        "n_chips": n_chips,
        "mesh_shape": dict(mesh.shape),
        "rank": list(mesh.coords),
        "trace_s": got["trace_s"],
        "memory": got["memory"],
        "memory_notes": MEMORY_NOTES,
        "flops_per_device": float(sum(got["flops"].values())),
        "flops_by_dtype": got["flops"],
        "bytes_per_device": float(got["bytes"]),
        "device_ops": got["ops"],
        "kernels": got["kernels"],
        "collectives": got["collectives"],
        "links": links,
        "layout": LAYOUT,
        "cache_layout": CACHE_LAYOUT if shape.kind != "train" else None,
        "n_params": int(n_params),
        "n_active_params": int(n_active),
        "tokens_per_step": int(toks),
        "model_flops": float(6.0 * n_active * toks),
        "roofline": roofline_terms(got["flops"], got["bytes"], got["collectives"], links),
    })
    return rec


def cell_path(arch: str, shape_name: str, mesh_name: str) -> Path:
    return OUT_DIR / mesh_name / f"{arch}__{shape_name}.json"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Dry run on the H100 production meshes: "
                                 "trace rank 0's step of every (arch x shape x mesh) cell "
                                 "on fake tensors and record its roofline inputs.")
    ap.add_argument("--arch", default="all", help="arch id or 'all'")
    ap.add_argument("--shape", default="all", choices=["all", *SHAPES])
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--force", action="store_true", help="recompute existing cells")
    ap.add_argument("--scan", action="store_true", help="(reference only: raises)")
    ap.add_argument("--save-hlo", action="store_true", help="(reference only: raises)")
    ap.add_argument("--opt", action="append", default=[],
                    help="perf knobs: kvq8 | infer-tp | a2a | cap10 | remat-none")
    ap.add_argument("--tag", default="", help="suffix for the output mesh dir")
    args = ap.parse_args(argv)
    for flag in ("scan", "save_hlo"):
        if getattr(args, flag):
            key = flag.replace("_", "-")
            raise SystemExit(f"--{key} has no counterpart in the port: {NOT_PORTED[key]}")
    try:
        check_opts(args.opt)
    except ValueError as e:
        raise SystemExit(str(e)) from None

    archs = list(ARCH_IDS) if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    n_ok = n_skip = n_fail = 0
    for multi in meshes:
        mesh_name = ("multi" if multi else "single") + (f"_{args.tag}" if args.tag else "")
        for arch in archs:
            for shape_name in shapes:
                path = cell_path(arch, shape_name, mesh_name)
                if path.exists() and not args.force:
                    print(f"[cached] {mesh_name} {arch} {shape_name}")
                    continue
                print(f"[run] {mesh_name} {arch} {shape_name} ...", flush=True)
                try:
                    rec = run_cell(arch, shape_name, multi, opts=tuple(args.opt))
                except Exception as e:  # record the failure; it is a bug to fix
                    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                           "status": "fail", "reason": f"{type(e).__name__}: {e}",
                           "traceback": traceback.format_exc()[-4000:]}
                rec["mesh"] = mesh_name
                path.parent.mkdir(parents=True, exist_ok=True)
                path.write_text(json.dumps(rec, indent=1))
                st = rec["status"]
                n_ok += st == "ok"
                n_skip += st == "skip"
                n_fail += st == "fail"
                print(f"  -> {st} {rec.get('reason', '')} "
                      f"(trace {rec.get('trace_s', '-')}s)", flush=True)
    print(f"done: ok={n_ok} skip={n_skip} fail={n_fail}")


if __name__ == "__main__":
    main()

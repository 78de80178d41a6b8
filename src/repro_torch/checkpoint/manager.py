"""ECC-protected checkpointing (the counterpart of
``repro.checkpoint.manager``).

Every leaf is serialized, cut into DIVA-codec bursts (SECDED + bit
interleave, ``memsys/codec.protect_blob``: the ``secded_encode`` and
``diva_shuffle`` kernels on a card) and written atomically (tmp + rename).
Restore verifies and corrects every burst (scrubbing: ``diva_shuffle`` and
``secded_syndrome``).

A state is a dict of numpy arrays or tensors, nested or flat (a train state
``{"params", "opt", "step"}``), flattened in sorted-key order at every level
— the order ``jax.tree_util`` gives a dict — so the on-disk layout matches
the reference's leaf for leaf and either package restores the other's
checkpoints:

    <dir>/step_<k>/meta.json + leaf_<i>.npy (+ leaf_<i>.ecc.npy: packed lanes)

``meta.json`` carries a ``treedef`` string so the reference's reader finds
every key it expects; ``restore`` here ignores it.

On a mesh (``shardings=``: a tree of ``sharding.NamedSharding`` matching
the state), ``save`` takes each rank's shards and gathers one leaf at a
time; rank (0, ..., 0) of the mesh copies it to the host and writes it
before the next is gathered, so all of them write the same layout.
``restore`` reads one whole leaf at a time on the host, keeps this rank's
shard of it and moves only that shard to the mesh's device — a checkpoint
saved on one mesh lands on another (elastic restore).  The device then
holds the shards and at most one whole leaf (with the codec's buffers for
it).
"""
from __future__ import annotations

import json
import shutil
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from repro_torch import sharding as shd
from repro_torch.device import resolve_device
from repro_torch.memsys import codec
from repro_torch.obs import REGISTRY as _OBS_REGISTRY
from repro_torch.obs import span as _span
from repro_torch.tree import tree_leaves, tree_unflatten

# Counters and duration histograms at the save/restore boundaries (host
# I/O), including the scrubbing signal: corrected codewords per restore.
_M_SAVES = _OBS_REGISTRY.counter(
    "repro_checkpoint_saves_total", "checkpoint steps written")
_M_RESTORES = _OBS_REGISTRY.counter(
    "repro_checkpoint_restores_total", "checkpoint steps restored")
_M_CORRECTED = _OBS_REGISTRY.counter(
    "repro_checkpoint_corrected_codewords_total",
    "SECDED-corrected codewords across restores (scrubbing signal)")
_M_SAVE_S = _OBS_REGISTRY.histogram(
    "repro_checkpoint_save_seconds", "checkpoint save wall time")
_M_RESTORE_S = _OBS_REGISTRY.histogram(
    "repro_checkpoint_restore_seconds", "checkpoint restore wall time")


def _flatten(state: dict) -> list:
    """The leaves in sorted-key order (jax's order for a dict)."""
    if not isinstance(state, dict):
        raise TypeError(f"a checkpoint state is a dict of arrays, got "
                        f"{type(state).__name__}")
    return tree_leaves(state)


def _treedef(tree) -> str:
    """The structure as jax prints a dict treedef (for the reference's
    reader; ``restore`` here follows its example state)."""
    if isinstance(tree, dict):
        return "{%s}" % ", ".join(f"{k!r}: {_treedef(tree[k])}" for k in sorted(tree))
    return "*"


# a bfloat16 leaf is stored as its raw 16-bit words: numpy has no bfloat16
# without ml_dtypes, so the .npy holds 2-byte void items (the reference's
# np.save of an ml_dtypes array reads back the same) and meta.json says
# "bfloat16"; the ECC sidecar covers the same words
_BF16 = "bfloat16"
_WORD = np.dtype("V2")


def _host(leaf) -> tuple[np.ndarray, str]:
    """The leaf as the array to write, and the dtype name for meta.json."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.int16).numpy().view(_WORD), _BF16
        return leaf.numpy(), str(leaf.numpy().dtype)
    arr = np.asarray(leaf)
    if arr.dtype.name == _BF16:   # an ml_dtypes array from the reference
        return arr.view(_WORD), _BF16
    return arr, str(arr.dtype)


def _words_to_bf16(words: np.ndarray) -> torch.Tensor:
    """2-byte words (any 2-byte dtype) as the bfloat16 tensor they encode."""
    return torch.from_numpy(np.ascontiguousarray(words).view(np.int16).copy()) \
        .view(torch.bfloat16)


@dataclass
class CheckpointManager:
    directory: str
    keep: int = 3
    protect: bool = True  # SECDED + DIVA interleave sidecars

    def __post_init__(self):
        # keep=0 would make _gc slice steps[:-0] == [] and silently retain
        # every step forever — reject it up front
        if self.keep < 1:
            raise ValueError(f"keep must be >= 1, got {self.keep}")
        self.dir = Path(self.directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        # a save() killed between mkdir and the atomic rename leaves a
        # .tmp_step_* behind; nothing ever publishes it, so sweep on init
        for orphan in self.dir.glob(".tmp_step_*"):
            shutil.rmtree(orphan, ignore_errors=True)

    # ----------------------------------------------------------------- save

    def save(self, step: int, state: dict, *, device=None, shardings=None) -> Path:
        """Write ``state`` as step ``step``; the codec runs on ``device``
        (default: the CUDA device, or the mesh's device with
        ``shardings``).  With ``shardings`` ``state`` holds this rank's
        shards: every rank of the mesh calls ``save``, the leaves are
        gathered one at a time and the mesh's first rank writes each before
        the next, and every rank returns once the step is published."""
        if shardings is None:
            return self._timed_save(step, state, device)
        shs = tree_leaves(shardings)
        mesh = shs[0].mesh

        def whole(i, leaf):   # a collective: every rank gathers leaf i in turn
            with torch.no_grad():
                return shs[i].gather(leaf)

        path = self.dir / f"step_{step}"
        # every rank has made its manager (whose start sweeps .tmp_step_*
        # dirs) before the writer makes its own
        _barrier(mesh)
        if not any(mesh.coords):
            path = self._timed_save(step, state, mesh.device if device is None else device,
                                    whole)
        else:
            for i, leaf in enumerate(_flatten(state)):
                whole(i, leaf)
        _barrier(mesh)
        return path

    def _timed_save(self, step, state, device, whole=None) -> Path:
        with _span("checkpoint.save", _M_SAVE_S, step=step):
            out = self._save(step, state, device, whole)
        _M_SAVES.inc()
        return out

    def _save(self, step: int, state: dict, device, whole=None) -> Path:
        """``whole(i, leaf)``, where given, makes leaf ``i`` whole before it
        goes to the host."""
        flat = _flatten(state)
        dev = resolve_device(device) if self.protect else None
        tmp = self.dir / f".tmp_step_{step}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        meta = {"step": step, "treedef": f"PyTreeDef({_treedef(state)})",
                "leaves": []}
        for i, leaf in enumerate(flat):
            arr, dtype = _host(leaf if whole is None else whole(i, leaf))
            meta["leaves"].append({"shape": list(arr.shape), "dtype": dtype,
                                   "nbytes": int(arr.nbytes)})
            np.save(tmp / f"leaf_{i}.npy", arr, allow_pickle=False)
            if self.protect:
                lanes = codec.protect_blob(arr.tobytes(), device=dev)
                np.save(tmp / f"leaf_{i}.ecc.npy",
                        np.packbits(lanes.astype(np.uint8), axis=1))
        (tmp / "meta.json").write_text(json.dumps(meta))
        final = self.dir / f"step_{step}"
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)  # atomic publish
        self._gc()
        return final

    def _gc(self):
        steps = sorted(self.steps())
        for s in steps[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

    def steps(self) -> list[int]:
        return sorted(int(p.name.split("_")[1]) for p in self.dir.glob("step_*"))

    def meta(self, step: int | None = None) -> dict:
        """The saved leaf metadata (shapes/dtypes in sorted-key order) of
        one step — what a restorer with a known key set but unknown array
        sizes needs to build its ``example_state``."""
        steps = self.steps()
        if not steps:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        step = steps[-1] if step is None else step
        return json.loads((self.dir / f"step_{step}" / "meta.json").read_text())

    # -------------------------------------------------------------- restore

    def restore(self, example_state: dict, step: int | None = None, *,
                device=None, shardings=None, verify: bool = True):
        """Restore into the structure, shapes and dtypes of ``example_state``
        (step: the newest by default).  The codec runs on ``device``
        (default: the CUDA device); a leaf whose example is a tensor comes
        back as a tensor on ``device``, any other as numpy.  With
        ``shardings`` (a tree of ``NamedSharding`` over the whole leaves'
        specs) each leaf comes back as a tensor, this rank's shard on the
        mesh's device (only the shard is moved there), whatever mesh saved
        it; ``example_state`` may then hold the whole leaves or this rank's
        shards.  Returns ``(state, {"step",
        "corrected_codewords"})``."""
        shs = None if shardings is None else tree_leaves(shardings)
        if shs is not None and device is None:
            device = shs[0].mesh.device
        with _span("checkpoint.restore", _M_RESTORE_S) as sp:
            state, info = self._restore(example_state, step, device, verify, shs)
            sp.set(step=info["step"])
        _M_RESTORES.inc()
        _M_CORRECTED.inc(info["corrected_codewords"])
        return state, info

    def _restore(self, example_state: dict, step: int | None, device,
                 verify: bool, shs=None):
        """``shs``: the leaves' shardings in flattened order, or ``None``."""
        flat = _flatten(example_state)
        wants_tensors = shs is not None or any(isinstance(x, torch.Tensor) for x in flat)
        dev = resolve_device(device) \
            if wants_tensors or (verify and self.protect) else None
        steps = self.steps()
        if not steps:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        step = steps[-1] if step is None else step
        d = self.dir / f"step_{step}"
        meta = json.loads((d / "meta.json").read_text())
        if len(meta["leaves"]) != len(flat):
            raise ValueError(f"step {step} has {len(meta['leaves'])} leaves; "
                             f"the example state has {len(flat)}")
        out = []
        n_corrected = 0
        for i, (leaf, info) in enumerate(zip(flat, meta["leaves"])):
            arr = np.load(d / f"leaf_{i}.npy", allow_pickle=False)
            if verify and self.protect and (d / f"leaf_{i}.ecc.npy").exists():
                packed = np.load(d / f"leaf_{i}.ecc.npy", allow_pickle=False)
                lanes = np.unpackbits(packed, axis=1)[:, :codec.BURST_LANES]
                raw, stats = codec.recover_blob(lanes, info["nbytes"],
                                                device=dev)
                if not stats.ok:
                    raise IOError(f"leaf {i}: {stats.uncorrectable} "
                                  f"uncorrectable codewords")
                n_corrected += stats.corrected
                dtype = np.int16 if info["dtype"] == _BF16 else info["dtype"]
                arr = np.frombuffer(raw, dtype=dtype).reshape(info["shape"]).copy()
            if info["dtype"] == _BF16:
                t = _words_to_bf16(arr)
                arr = t if isinstance(leaf, torch.Tensor) or shs is not None \
                    else t.float().numpy()
            if shs is not None:
                # the whole leaf stays on the host: only this rank's shard moves
                t = torch.as_tensor(arr).reshape(info["shape"])
                dtype = leaf.dtype if isinstance(leaf, torch.Tensor) \
                    else torch.from_numpy(np.empty(0, np.asarray(leaf).dtype)).dtype
                out.append(shs[i].shard(t).to(dev, dtype, copy=True))
            elif isinstance(leaf, torch.Tensor):
                out.append(torch.as_tensor(arr).to(dev, leaf.dtype).reshape(leaf.shape))
            else:
                ex = np.asarray(leaf)
                out.append(arr.astype(ex.dtype).reshape(ex.shape))
        return tree_unflatten(example_state, out), {"step": step,
                                                    "corrected_codewords": n_corrected}


def _barrier(mesh) -> None:
    """Every rank of ``mesh`` waits for every other (an all-reduce over each
    axis, read back on the host)."""
    t = torch.zeros((), device=mesh.device)
    shd.all_reduce_(t, mesh, mesh.axis_names).item()

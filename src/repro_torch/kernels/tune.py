"""Measured launch tuner for the kernel registry.

The counterpart of ``repro/kernels/tune.py``, aimed at the card: what it
varies is each CUDA kernel's launch configuration (the settings of its
spec's ``launch_space``, ``kernels/registry.py``), not Pallas tiles.  One
winner per ``(kernel, backend_tag, shape-bucket)``: the first concrete call
of a bucket on a sweep-eligible route times every setting of the space
(CUDA events on the current stream, one warm-up launch, which also builds
the library, then the best of ``_TIMING_ITERS``) and caches the fastest in
an in-process dict, with optional JSON persistence
(``kernels/_build/TUNE_kernels.json``, git-ignored; nothing loads it unless
asked to).

Backend tags: ``cuda-sm<major><minor>`` for a CUDA tensor (``cuda-sm90`` on
the H100), ``cpu-plain`` for a CPU tensor.

Hard rules, in order:

* **Never sweep under a trace.**  Fake tensors (``counting.is_fake``, the
  dry run), an active ``counting.WorkCounter`` (the dry run's card-side
  checks) and a CUDA graph being captured take the cached winner or the
  default, silently.
* **Sweep only where measurement is the point**: a CUDA tensor sweeps on the
  first concrete call of its bucket; a CPU tensor only under
  ``REPRO_AUTOTUNE=1``, where every setting runs the plain version (which
  has no launch to configure): that exercises the machinery and nothing
  else, like the reference's interpret route.
* **Settings can't change results.**  Each candidate's output is held bit
  for bit against the default setting's output of the same call; a
  difference raises ``SettingMismatch`` (a kernel fault, not a slower
  setting).  A launch the card refuses (``build.LaunchError``) is a skip;
  the default itself must launch.
* **No side effects.**  A sweep's launches write scratch outputs and count
  nowhere: not in a wrapper's ``launches``, ``bank_sched``'s route counts,
  ``rc_transient``'s route counters or a work counter.  The wrapper then
  launches once with the winner, and counts that launch.

Sweeps are recorded through the obs registry (``repro_kernel_tune_total``,
labeled ``kernel``/``backend``): one inc per sweep, not per candidate.
"""
from __future__ import annotations

import functools
import json
import math
import os
import time
from pathlib import Path
from typing import Any, Callable

import torch

from repro_torch.counting import active_counter, fake_mode_active, is_fake
from repro_torch.kernels.build import BUILD_DIR, LaunchError
from repro_torch.obs import REGISTRY as _OBS_REGISTRY

_TIMING_ITERS = 3

#: (kernel, backend_tag, bucket) -> winning launch setting
_TUNE_CACHE: dict[tuple[str, str, int], dict[str, Any]] = {}

_TUNE_SWEEPS = _OBS_REGISTRY.counter(
    "repro_kernel_tune_total",
    "launch-space autotune sweeps by (kernel, backend); one inc per sweep "
    "(winners are cached per shape bucket)",
    labelnames=("kernel", "backend"))

DEFAULT_CACHE_PATH = BUILD_DIR / "TUNE_kernels.json"


class SettingMismatch(RuntimeError):
    """A launch setting gave other bits than the default: a kernel fault."""


def autotune_enabled() -> bool:
    return os.environ.get("REPRO_AUTOTUNE", "0") == "1"


def bucket_pow2(n: int) -> int:
    """Round a bucket extent up to a power of two: the cache granularity.
    Chunked callers hit one bucket per chunk shape, so they tune once."""
    n = max(int(n), 1)
    return 1 << (n - 1).bit_length()


@functools.cache
def _cuda_tag(index: int) -> str:
    major, minor = torch.cuda.get_device_capability(index)
    return f"cuda-sm{major}{minor}"


def backend_tag(t: torch.Tensor) -> str:
    """``cuda-sm<major><minor>`` for a CUDA tensor, ``cpu-plain`` else."""
    if t.device.type == "cuda":
        index = t.device.index
        return _cuda_tag(torch.cuda.current_device() if index is None else index)
    return "cpu-plain"


def _tensors(args) -> list:
    return [a for a in args if isinstance(a, torch.Tensor)]


def _traced(tensors) -> bool:
    """Fake tensors, a fake mode or a work counter active, or a CUDA graph
    being captured: no wall clock here means anything."""
    if any(is_fake(t) for t in tensors) or fake_mode_active() \
            or active_counter() is not None:
        return True
    return tensors[0].device.type == "cuda" and torch.cuda.is_current_stream_capturing()


def lookup(kernel: str, backend: str, bucket: int) -> dict[str, Any] | None:
    return _TUNE_CACHE.get((kernel, backend, bucket))


def clear() -> None:
    _TUNE_CACHE.clear()


def same_bits(a, b) -> bool:
    """Two outputs (tensors, or tuples/lists/dicts of them, or None) equal
    bit for bit: the same dtypes, shapes and bytes."""
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


def _time_once(run: Callable, setting: dict, cuda: bool):
    """(best seconds of ``_TIMING_ITERS`` runs, the warm-up run's output).
    The warm-up builds the library and is not timed."""
    out = run(setting)
    best = math.inf
    if cuda:
        stream = torch.cuda.current_stream()
        for _ in range(_TIMING_ITERS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(stream)
            run(setting)
            end.record(stream)
            end.synchronize()
            best = min(best, start.elapsed_time(end) * 1e-3)
    else:
        for _ in range(_TIMING_ITERS):
            t0 = time.perf_counter()
            run(setting)
            best = min(best, time.perf_counter() - t0)
    return best, out


def _sweep(spec, run: Callable, cuda: bool) -> dict[str, Any]:
    """Time every setting of the space; return the fastest.  Each
    candidate's output must equal the default's bit for bit."""
    best_t, best, want = math.inf, {}, None
    for i, launch in enumerate(spec.launch_space):
        try:
            t, out = _time_once(run, spec.setting(launch), cuda)
        except LaunchError:   # a launch the card refuses is a skip
            if i == 0:
                raise
            continue
        if i == 0:
            want = out
        elif not same_bits(out, want):
            raise SettingMismatch(f"{spec.name}: launch {launch} gives other bits "
                                  f"than the default {spec.defaults}")
        del out
        if t < best_t:
            best_t, best = t, dict(launch)
    return best


def get_launch(name: str, args: tuple, kw: dict, run: Callable) -> dict[str, int]:
    """The full launch constants of one call of kernel ``name``.

    ``args``/``kw`` are the call's tensors and statics (the spec's
    ``bucket`` reads them); ``run(setting)`` runs the call at the full
    ``setting`` and returns its output without counting anything (scratch
    outputs and counters).  Returns the cached winner for this (kernel,
    backend, bucket), sweeping first when eligible; the defaults
    (``launch_space[0]``) otherwise.  An empty call is not tuned.
    """
    from repro_torch.kernels.registry import REGISTRY
    spec = REGISTRY[name]
    tensors = _tensors(args)
    extent = spec.bucket(args, kw)
    if extent == 0 or any(is_fake(t) for t in tensors):
        return spec.setting({})
    tag = backend_tag(tensors[0])
    key = (name, tag, bucket_pow2(extent))
    hit = _TUNE_CACHE.get(key)
    if hit is not None:
        return spec.setting(hit)
    cuda = tensors[0].device.type == "cuda"
    if not (cuda or autotune_enabled()) or _traced(tensors):
        return spec.setting({})
    winner = _sweep(spec, run, cuda)
    _TUNE_CACHE[key] = winner
    _TUNE_SWEEPS.labels(kernel=name, backend=tag).inc()
    return spec.setting(winner)


def resolve(name: str, launch: dict | None, args: tuple, kw: dict,
            run: Callable) -> dict[str, int]:
    """A wrapper's launch constants: ``launch`` checked against the space
    (ValueError outside it, on the CPU too), or with ``launch=None`` the
    tuner's choice (``get_launch``)."""
    if launch is not None:
        from repro_torch.kernels.registry import REGISTRY
        return REGISTRY[name].setting(launch)
    return get_launch(name, args, kw, run)


# --------------------------------------------------------- JSON persistence

def save_cache(path: str | Path = DEFAULT_CACHE_PATH) -> Path:
    """Persist the in-process winners; key format ``kernel|backend|bucket``."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    blob = {f"{k}|{b}|{n}": setting
            for (k, b, n), setting in sorted(_TUNE_CACHE.items())}
    path.write_text(json.dumps(blob, indent=2) + "\n")
    return path


def load_cache(path: str | Path = DEFAULT_CACHE_PATH) -> int:
    """Load persisted winners (merging over in-process entries); returns the
    number of entries loaded.  Missing file is not an error: tuning is an
    optimization, never a requirement."""
    path = Path(path)
    if not path.exists():
        return 0
    blob = json.loads(path.read_text())
    for key, setting in blob.items():
        kernel, backend, bucket = key.rsplit("|", 2)
        _TUNE_CACHE[(kernel, backend, int(bucket))] = dict(setting)
    return len(blob)

"""The DIMM axis over several devices: the counterpart of the population part
of ``repro.sharding`` (``dimm_mesh``, ``chunk_spans``).

A ``DimmMesh`` is a 1-D list of torch devices.  An entry point given
``mesh=`` splits its batch arguments' DIMM axis into ``mesh.size`` contiguous
shards (``core/substrate._run_sharded``), runs its eager program on each
shard on that shard's device and gathers the outputs on ``devices[0]``.
Every draw is keyed by a DIMM's serial, which travels with its shard, so no
split changes an integer or a decision.  A device may repeat
(``DimmMesh(["cpu"] * 3)``, ``DimmMesh(["cuda:0"] * 2)``): the split, the
clone padding and the gather then run on one device, back to back on its
stream.  That measures the cost of the split and the gather, not a speed-up
across cards.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.device import resolve_device


@dataclass(frozen=True)
class DimmMesh:
    """A 1-D device mesh over the DIMM axis.  ``devices`` may repeat a
    device; a CUDA entry gets its index (``resolve_device``), and one raises
    when CUDA is not available: no shard quietly runs on the CPU."""
    devices: tuple

    def __post_init__(self):
        devs = tuple(resolve_device(torch.device(d)) for d in self.devices)
        if not devs:
            raise ValueError("a DimmMesh needs at least one device")
        object.__setattr__(self, "devices", devs)

    @property
    def size(self) -> int:
        return len(self.devices)


def dimm_mesh(n_devices: int | None = None, *, device=None) -> DimmMesh:
    """The first ``n_devices`` CUDA devices (default: every visible one) as a
    ``DimmMesh``; raises when more are asked for than are visible, or when
    there is no CUDA.  ``device="cpu"`` gives ``n_devices`` CPU entries
    (default 1), the CPU tests' mesh.  Never falls back to the CPU."""
    kind = "cuda" if device is None else torch.device(device).type
    if kind == "cpu":
        n = 1 if n_devices is None else n_devices
        if n <= 0:
            raise ValueError(f"dimm_mesh({n_devices}): need at least one device")
        return DimmMesh(("cpu",) * n)
    if kind != "cuda":
        raise ValueError(f"dimm_mesh: device must be 'cuda' or 'cpu', got "
                         f"{device!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("dimm_mesh: no CUDA device; pass device='cpu' for "
                           "a CPU mesh")
    count = torch.cuda.device_count()
    n = count if n_devices is None else n_devices
    if not 0 < n <= count:
        raise ValueError(f"dimm_mesh({n_devices}): only {count} device(s) "
                         "visible")
    return DimmMesh(tuple(torch.device("cuda", i) for i in range(n)))


def mesh_device(mesh: DimmMesh | None, device=None) -> torch.device:
    """Where an entry point places its inputs and gathers its result: the
    mesh's first device (``device`` is then ignored), else ``device``
    (default: the current CUDA device)."""
    return resolve_device(device) if mesh is None else mesh.devices[0]


def chunk_spans(n_dimms: int, chunk_size: int,
                mesh: DimmMesh | None = None) -> list[tuple[int, int]]:
    """[lo, hi) population spans of a chunked scan: fixed-size chunks that
    tile [0, n_dimms) exactly, in serial order.  With a ``mesh`` the chunk
    size is rounded up to a multiple of its size, so every full chunk splits
    evenly and only the last, ragged one needs the shard split's clone
    padding."""
    if n_dimms < 0 or chunk_size <= 0:
        raise ValueError(f"need n_dimms >= 0 < chunk_size; got "
                         f"({n_dimms}, {chunk_size})")
    if mesh is not None:
        chunk_size += (-chunk_size) % mesh.size
    return [(lo, min(lo + chunk_size, n_dimms))
            for lo in range(0, n_dimms, chunk_size)]

"""The device an entry point of the port runs on."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` when given, else the current CUDA device.  A CUDA device
    without an index gets the current one, so that it compares equal to the
    device of a tensor made on it.  Raises when CUDA is asked for, or no
    device is given, and CUDA is not available: the port never carries on
    quietly on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "port on the CPU")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev

"""Chunked sequence scan with recompute at chunk boundaries.

The counterpart of ``repro.models.scan_utils``.  A plain loop over S
timesteps under autograd keeps every step's residuals for the backward pass:
for Mamba's recurrence at Jamba's full width, about three (B, 16384, 16)
float32 tensors a step, ~25 MB at B = 8, so ~90 GB over 512 steps and one
block's 7 Mamba sublayers.  Looping over chunks, each under a non-reentrant
``torch.utils.checkpoint`` (the reference's ``jax.checkpoint(chunk_body)``),
keeps only the chunk-boundary carries and recomputes one chunk at a time in
the backward: memory ~ (S / chunk) x carry + chunk x step residuals.
Non-reentrant checkpoints nest, so the scan may run inside a layer's own
checkpoint (``remat == "full"``).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint


def _loop(step, carry, xs):
    """``step`` over the leading (time) axis of the tuple ``xs``: (carry,
    the outputs stacked over time)."""
    ys = []
    for t in range(xs[0].shape[0]):
        carry, y = step(carry, tuple(x[t] for x in xs))
        ys.append(y)
    return carry, torch.stack(ys)


def chunked_scan(step, init, xs: tuple, *, chunk: int = 128):
    """``step(carry, inputs_t) -> (carry, y_t)`` over time, as ``lax.scan``.

    ``xs``: a tuple of time-major tensors (S, ...).  When ``S <= chunk`` or
    ``S % chunk != 0`` a plain loop over time runs; otherwise a loop over
    ``S // chunk`` chunks, each under ``checkpoint`` where autograd records
    (grad mode on and an input that requires grad).  Returns (final carry,
    ys stacked over time)."""
    S = xs[0].shape[0]
    if S <= chunk or S % chunk != 0:
        return _loop(step, init, xs)
    records = torch.is_grad_enabled() and any(t.requires_grad for t in (init, *xs))
    carry, ys = init, []
    for c in range(S // chunk):
        xc = tuple(x[c * chunk:(c + 1) * chunk] for x in xs)
        if records:
            carry, yc = checkpoint(_loop, step, carry, xc, use_reentrant=False)
        else:
            carry, yc = _loop(step, carry, xc)
        ys.append(yc)
    return carry, torch.cat(ys)

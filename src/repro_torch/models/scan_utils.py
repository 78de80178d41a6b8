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

Counted on fake tensors (the dry run, ``counting.WorkCounter``), a loop of
n > 3 steps traces three: the first, one that stands for the n - 2 inside
(``counting.stand_for``: its ops, its backward and the storages it leaves
alive count n - 2 times) and the last, each from the carry before it.  The
first and the last differ from the others in their backward (the carry
coming in may need no gradient; the one going out may get none), so every
one of the n steps is counted, forward and backward, as the loop would be.
A scan of more than 3 chunks does the same with its chunks (the first, one
standing for the inner ones, the last), so a fake scan traces at most 9
steps, whatever S.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.counting import scan_counter, stand_for


def _standing(counter, run, n: int, outer: int, cat):
    """``run(i, carry, weight)`` for the first, one inner (standing for the
    n - 2 inside) and the last of ``n`` > 3 parts, ``cat`` of the n
    outputs; each part's weight is ``outer`` times its share."""
    ys = []
    carry = None
    for i, w in ((0, 1), (1, n - 2), (n - 1, 1)):
        carry, y = stand_for(counter, lambda i=i, w=w, c=carry: run(i, c, outer * w),
                             outer * w, w)
        ys.append(y)
    # the inner part's output n - 2 times; its copies pass no gradient
    ys = [ys[0], ys[1]] + [ys[1].detach()] * (n - 3) + [ys[2]]
    with counter.scaled(outer):
        return carry, cat(ys)


def _loop(step, carry, xs, outer: int = 1):
    """``step`` over the leading (time) axis of the tuple ``xs``: (carry,
    the outputs stacked over time).  ``outer``: how many loops this one
    stands for (a fake scan's inner chunk)."""
    n = xs[0].shape[0]
    counter = scan_counter(xs[0])
    if counter is not None and n > 3:
        init = carry

        def run(t, c, _w):
            return step(init if t == 0 else c, tuple(x[t] for x in xs))
        return _standing(counter, run, n, outer, torch.stack)
    ys = []
    for t in range(n):
        carry, y = step(carry, tuple(x[t] for x in xs))
        ys.append(y)
    if counter is None:
        return carry, torch.stack(ys)
    with counter.scaled(outer):
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

    def run(c, carry, outer):
        xc = tuple(x[c * chunk:(c + 1) * chunk] for x in xs)
        if records:
            # the scan draws no random numbers (see model._run_stack)
            return checkpoint(_loop, step, carry, xc, outer, use_reentrant=False,
                              preserve_rng_state=False)
        return _loop(step, carry, xc, outer)

    n_chunks = S // chunk
    counter = scan_counter(xs[0])
    if counter is not None and n_chunks > 3:
        return _standing(counter, lambda c, carry, outer: run(c, init if c == 0 else carry,
                                                              outer),
                         n_chunks, 1, torch.cat)
    carry, ys = init, []
    for c in range(n_chunks):
        carry, yc = run(c, carry, 1)
        ys.append(yc)
    return carry, torch.cat(ys)

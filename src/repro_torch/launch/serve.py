"""Serving: batched prefill + greedy decode of a ported model.

    python -m repro_torch.launch.serve --arch rwkv6-1.6b                 # on the card
    python -m repro_torch.launch.serve --arch rwkv6-1.6b --smoke --device cpu

The counterpart of ``repro.launch.serve`` for the LLM path, with random
parameters from a seed (the repo has no weights).  The DIMM-fleet service
(``--fleet``) and the observability outputs (``--metrics-out``,
``--trace-out``) wait for ``serve/`` and ``obs/`` (ROADMAP queue 1 #3).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.registry import ARCH_IDS, get_config, get_smoke_config
from repro_torch.data.pipeline import make_batch
from repro_torch.device import resolve_device
from repro_torch.launch import steps as steps_mod
from repro_torch.models import model as model_mod


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def generate(cfg, params, prompt_batch, *, max_new: int = 16, device=None):
    """Greedy generation for a batch of prompts (``prompt_batch["tokens"]``:
    (B, S) integers) on ``device`` (default: the CUDA device), where
    ``params`` must lie.  Returns (generated tokens (B, max_new) int32,
    stats).  The stats' wall times are host clocks around work that ends in
    a ``torch.cuda.synchronize`` on the card: compute, not the enqueue."""
    dev = resolve_device(device)
    if model_mod.param_device(params) != dev:
        raise ValueError(f"params lie on {model_mod.param_device(params)}, "
                         f"generate runs on {dev}")
    # cast once: prefill and decode cast again, a no-op on a cast tree
    params = model_mod.cast_params(params, cfg)
    tokens = torch.as_tensor(np.asarray(prompt_batch["tokens"]), device=dev)
    B = tokens.shape[0]
    prefill = steps_mod.make_prefill_step(cfg)
    decode = steps_mod.make_decode_step(cfg)
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = prefill(params, {"tokens": tokens})
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = [tok]
    for _ in range(max_new - 1):
        tok, cache = decode(params, cache, {"tokens": tok[:, None]})
        out.append(tok)
    toks = torch.stack(out, dim=1)
    _sync(dev)
    t_decode = time.perf_counter() - t0
    return toks, {"prefill_s": t_prefill, "decode_s": t_decode,
                  "tok_per_s": B * (max_new - 1) / max(t_decode, 1e-9)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="rwkv6-1.6b", choices=list(ARCH_IDS))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    params = model_mod.init_params(0, cfg, device=args.device)
    batch = make_batch(cfg, args.batch, args.prompt_len, seed=0, step=0)
    batch["tokens"] = batch["tokens"][:, :-1]
    toks, stats = generate(cfg, params, batch, max_new=args.tokens,
                           device=args.device)
    print(f"{args.arch}: generated {tuple(toks.shape)} on {toks.device} "
          f"prefill={stats['prefill_s']:.2f}s "
          f"decode={stats['decode_s']:.2f}s "
          f"({stats['tok_per_s']:.1f} tok/s)")
    assert toks.shape == (args.batch, args.tokens)
    assert bool(((toks >= 0) & (toks < cfg.vocab_size)).all())
    return stats


if __name__ == "__main__":
    main()

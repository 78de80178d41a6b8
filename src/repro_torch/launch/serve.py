"""Serving driver: batched prefill + greedy decode of a ported model — or,
with ``--fleet``, the DIMM-fleet timing-table service
(``repro_torch.serve.FleetServer``).

    python -m repro_torch.launch.serve                     # qwen2-0.5b, on the card
    python -m repro_torch.launch.serve --arch qwen2-0.5b --smoke --device cpu
    python -m repro_torch.launch.serve --arch rwkv6-1.6b   # on the card
    python -m repro_torch.launch.serve --arch rwkv6-1.6b --smoke --device cpu
    python -m repro_torch.launch.serve --arch jamba-1.5-large-398b --smoke --device cpu
    python -m repro_torch.launch.serve --arch paligemma-3b   # on the card
    python -m repro_torch.launch.serve --arch whisper-medium --smoke --device cpu
    python -m repro_torch.launch.serve --fleet 256 --chunk 128 [--ckpt-dir D]
    python -m repro_torch.launch.serve --fleet 64 --chunk 32 --device cpu

The counterpart of ``repro.launch.serve``, with random model parameters from
a seed (the repo has no weights).  ``--metrics-out F`` dumps the obs registry
(Prometheus text) and ``--trace-out F`` records the run as Chrome
trace-event JSON.  A model is served under the 1x1 host mesh
(``use_mesh(make_host_mesh())``), as the reference does: MoE layers take
the expert-parallel path, which on one rank equals the local path.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import obs
from repro_torch.configs.registry import ARCH_IDS, get_config, get_smoke_config
from repro_torch.data.pipeline import make_batch
from repro_torch.device import resolve_device
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import model as model_mod
from repro_torch.sharding import use_mesh


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def generate(cfg, params, prompt_batch, *, max_new: int = 16, device=None):
    """Greedy generation for a batch of prompts (``prompt_batch["tokens"]``:
    (B, S) integers, with vlm's ``"patches"`` or audio's ``"frames"``; each
    moved to ``device``) on ``device`` (default: the CUDA device), where
    ``params`` must lie.  An attention cache holds the positions the run
    writes: S + max_new, and a vlm's patches in front (the reference sizes
    it S + max_new there too, short of its patches).  Returns (generated
    tokens (B, max_new) int32, stats).  The stats' wall times come from
    ``obs`` spans, host clocks around work that ends in a
    ``torch.cuda.synchronize`` on the card (``Span.bind``): compute, not
    the enqueue.  Runs without autograd."""
    dev = resolve_device(device)
    if model_mod.param_device(params) != dev:
        raise ValueError(f"params lie on {model_mod.param_device(params)}, "
                         f"generate runs on {dev}")
    # cast once: prefill and decode cast again, a no-op on a cast tree
    params = model_mod.cast_params(params, cfg)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in prompt_batch.items()}
    B, S = batch["tokens"].shape
    prefix = batch["patches"].shape[1] if cfg.family == "vlm" else 0
    prefill = steps_mod.make_prefill_step(cfg, max_seq=prefix + S + max_new)
    decode = steps_mod.make_decode_step(cfg)
    _sync(dev)
    with torch.no_grad(), obs.span("serve.prefill", batch=B, prompt_len=S) as sp:
        logits, cache = prefill(params, batch)
        tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        sp.bind(tok)
    t_prefill = sp.duration_s
    with torch.no_grad(), obs.span("serve.decode", batch=B, tokens=max_new) as sp:
        out = [tok]
        for _ in range(max_new - 1):
            tok, cache = decode(params, cache, {"tokens": tok[:, None]})
            out.append(tok)
        toks = torch.stack(out, dim=1)
        sp.bind(toks)
    t_decode = sp.duration_s
    return toks, {"prefill_s": t_prefill, "decode_s": t_decode,
                  "tok_per_s": B * (max_new - 1) / max(t_decode, 1e-9)}


def serve_fleet(n_dimms: int, chunk_size: int,
                ckpt_dir: str | None = None, device=None) -> dict:
    """Stand up the DIMM-fleet timing-table service over a synthetic TINY
    fleet on ``device`` (default: the CUDA device): ingest every DIMM,
    report the serving-path split, optionally checkpoint the state, and
    return the ingest stats + staleness report + the server's metrics."""
    from repro_torch.core.geometry import TINY
    from repro_torch.core.population import synthetic_fleet
    from repro_torch.serve import FleetConfig, FleetServer

    fleet = synthetic_fleet(n_dimms, TINY, seed=0, device=device)
    server = FleetServer(fleet, FleetConfig(chunk_size=chunk_size),
                         checkpoint_dir=ckpt_dir)
    with obs.span("serve.fleet_ingest", n_dimms=n_dimms) as sp:
        stats = server.ingest(now=0.0)
    stats["ingest_s"] = round(sp.duration_s, 2)
    stats.update(server.staleness())
    stats["metrics"] = server.metrics()
    if ckpt_dir is not None:
        server.save(step=0)
    print(f"fleet: {stats['ingested']} DIMMs in {stats['ingest_s']}s on "
          f"{server.device} -> hits={stats['hits']} "
          f"misses={stats['misses']} conventional={stats['conventional']} "
          f"generations={stats['n_generations']}, staleness bound "
          f"{stats['bound_years']:.2f}y"
          + (f", checkpoint -> {ckpt_dir}" if ckpt_dir else ""))
    return stats


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b", choices=list(ARCH_IDS))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--fleet", type=int, default=0,
                    help="serve a DIMM fleet of this size instead of an LLM")
    ap.add_argument("--chunk", type=int, default=128,
                    help="fleet ingest chunk size (with --fleet)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (with --fleet)")
    ap.add_argument("--metrics-out", default=None,
                    help="write the obs registry as Prometheus text here")
    ap.add_argument("--trace-out", default=None,
                    help="record spans; write Chrome trace-event JSON here")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)

    if args.trace_out:
        obs.start_tracing()
    try:
        if args.fleet:
            stats = serve_fleet(args.fleet, args.chunk, args.ckpt_dir,
                                device=args.device)
        else:
            cfg = get_smoke_config(args.arch) if args.smoke \
                else get_config(args.arch)
            params = model_mod.init_params(0, cfg, device=args.device)
            batch = make_batch(cfg, args.batch, args.prompt_len, seed=0,
                               step=0)
            batch["tokens"] = batch["tokens"][:, :-1]
            with use_mesh(make_host_mesh(device=args.device)):
                toks, stats = generate(cfg, params, batch, max_new=args.tokens,
                                       device=args.device)
            print(f"{args.arch}: generated {tuple(toks.shape)} on "
                  f"{toks.device} prefill={stats['prefill_s']:.2f}s "
                  f"decode={stats['decode_s']:.2f}s "
                  f"({stats['tok_per_s']:.1f} tok/s)")
            assert toks.shape == (args.batch, args.tokens)
            assert bool(((toks >= 0) & (toks < cfg.vocab_size)).all())
    finally:
        if args.trace_out:
            obs.stop_tracing()
            print(f"trace  -> {obs.write_chrome_trace(args.trace_out)}")
        if args.metrics_out:
            with open(args.metrics_out, "w") as f:
                f.write(obs.REGISTRY.prometheus_text())
            print(f"metrics -> {args.metrics_out}")
    return stats


if __name__ == "__main__":
    main()

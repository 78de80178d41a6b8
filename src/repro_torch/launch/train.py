"""Training entry point: ``python -m repro_torch.launch.train --arch <id> [--smoke]``.

    python -m repro_torch.launch.train --batch 8 --seq 512    # qwen2-0.5b, on the card
    python -m repro_torch.launch.train --arch qwen2-0.5b --smoke --device cpu
    python -m repro_torch.launch.train --arch rwkv6-1.6b      # on the card
    python -m repro_torch.launch.train --arch rwkv6-1.6b --smoke --device cpu
    python -m repro_torch.launch.train --arch jamba-1.5-large-398b --smoke --device cpu
    python -m repro_torch.launch.train --arch paligemma-3b --smoke --device cpu
    python -m repro_torch.launch.train --arch whisper-medium --batch 8 --seq 448   # on the card

The counterpart of ``repro.launch.train``: config -> parameters (random,
from a seed) -> the state put onto the mesh (``make_host_mesh()``, or
``--production-mesh``: (16, 16) over 256 ranks, which raises in a smaller
world) -> the sharded train step (``launch/steps.make_sharded_train_step``:
loss, autograd, through the ``wkv6`` kernels for rwkv6, the expert-parallel
MoE path, gradients averaged over the batch shards, clipping, schedule,
optimizer) -> synthetic data pipeline (prefetched) -> ECC-protected
checkpoints, saved from and restored onto the mesh (``shardings=``) ->
DIVA-style canary straggler monitor over the mesh's ranks.  As in the
reference, the data stream starts at its step 0 also after ``--resume``.
Over several ranks, give each rank its own card before anything else
(``torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))`` under torchrun,
or ``--device cuda:<local rank>``: the default is the current CUDA device,
cuda:0 on every rank otherwise, and NCCL refuses two ranks on one card),
then initialize ``torch.distributed`` (NCCL) and call ``main`` on every
rank.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.registry import ARCH_IDS, get_config, get_smoke_config
from repro_torch.data import Prefetcher, SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models import model as model_mod
from repro_torch.sharding import shard_tree
from repro_torch.optim import get_optimizer
from repro_torch.runtime.straggler import CanaryProber, ClusterSim


def build_state(cfg, seed: int = 0, device=None):
    """``{"params", "opt", "step"}`` on ``device`` (default: the CUDA
    device), with random parameters from ``seed``."""
    params = model_mod.init_params(seed, cfg, device=device)
    opt = get_optimizer(cfg.optimizer)
    return {"params": params, "opt": opt.init(params),
            "step": torch.zeros((), dtype=torch.int32, device=model_mod.param_device(params))}


def main(argv=None) -> dict:
    """Train for ``--steps``; returns ``{"final_loss", "losses"}`` (the logged
    losses) as the reference does, and ``"step_s"``: each step's wall seconds
    (host clock; on a card, up to a synchronize)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b", choices=list(ARCH_IDS))
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--production-mesh", action="store_true",
                    help="the (16, 16) data x model mesh over 256 ranks")
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    dev = resolve_device(args.device)
    mesh = make_production_mesh(device=dev) if args.production_mesh \
        else make_host_mesh(device=dev)

    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    state = build_state(cfg, device=dev)
    state_sh = steps_mod.state_shardings(state, mesh)
    state = shard_tree(state, state_sh)   # the whole state is freed here
    step_fn = steps_mod.make_sharded_train_step(cfg, mesh, state_sh,
                                                total_steps=max(args.steps, 100))
    start = 0
    if ckpt and args.resume and ckpt.steps():
        state, info = ckpt.restore(state, shardings=state_sh)
        start = info["step"]
        print(f"resumed from step {start} ({info['corrected_codewords']} codewords corrected)")

    data = Prefetcher(SyntheticLM(cfg, args.batch, args.seq, seed=0))
    prober = CanaryProber(ClusterSim(n_pods=1, devices_per_pod=max(mesh.size, 1)))
    losses, step_s = [], []
    t0 = time.time()
    for i, batch in zip(range(start, args.steps), data):
        ts = time.perf_counter()
        state, metrics = step_fn(state, batch)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        step_s.append(time.perf_counter() - ts)
        verdict = prober.run_step()
        if (i + 1) % args.log_every == 0 or i == start:
            loss = float(metrics["loss"])
            losses.append(loss)
            print(f"step {i+1:5d} loss {loss:.4f} gnorm {float(metrics['gnorm']):.3f} "
                  f"lr {float(metrics['lr']):.2e} timeout {verdict['timeout_ms']:.1f}ms")
        if ckpt and (i + 1) % args.ckpt_every == 0:
            path = ckpt.save(i + 1, state, shardings=state_sh)
            print(f"  checkpoint -> {path}")
    dt = time.time() - t0
    print(f"done: {args.steps - start} steps in {dt:.1f}s")
    return {"final_loss": losses[-1] if losses else None, "losses": losses,
            "step_s": step_s}


if __name__ == "__main__":
    main()

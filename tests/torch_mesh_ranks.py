"""Multi-rank runs for the training-mesh tests, and the reference's runs on
forced host devices.

Not a test module: ``test_torch_mesh_train.py``, ``test_torch_moe_ep.py``
and ``test_torch_sharded_serve.py`` import it.  ``spawn`` starts ``world`` processes (spawned, so each rank
imports this module by name: it imports neither ``jax`` nor ``repro`` at
the top), joins them to a gloo process group through a ``FileStore`` (no
port, so concurrent test workers never collide), runs a rank body and
collects what each rank returns.  ``reference`` runs the reference's
sharded step in a subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=N`` set before ``jax`` is
imported (the tests' own process keeps one device), one subprocess per
(arch, mesh, path): the reference reads ``REPRO_MOE_A2A`` when it traces its
layer scan and caches that trace.

    python tests/torch_mesh_ranks.py ref <spec.json>         # the reference's side
    python tests/torch_mesh_ranks.py serve_ref <spec.json>   # its sharded serving
"""
from __future__ import annotations

import json
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
SRC = HERE.parent / "src"

# the parity runs: 3 steps of SyntheticLM(cfg, BATCH, SEQ, seed=0), float32
STEPS, BATCH, SEQ = 3, 4, 32
STEP_KW = dict(warmup=0, total_steps=100)


# ------------------------------------------------------------------ trees

def flat_paths(tree, prefix=()):
    """{"a/b/c": leaf} in sorted-key order."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(flat_paths(tree[k], prefix + (str(k),)))
        return out
    return {"/".join(prefix): tree}


def unflat_paths(flat):
    tree: dict = {}
    for key, leaf in flat.items():
        node = tree
        *head, last = key.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = leaf
    return tree


# ------------------------------------------------------------------ spawn

def _entry(rank, world, store, fn_name, args, out_dir):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    try:
        result = globals()[fn_name](rank, *args)
    finally:
        dist.destroy_process_group()
    with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(result, f)


def spawn(fn_name: str, world: int, tmp: Path, *args) -> list:
    """Run ``fn_name(rank, *args)`` on ``world`` gloo ranks; each rank's
    return value, in rank order."""
    import torch.multiprocessing as mp
    tmp = Path(tmp)
    tmp.mkdir(parents=True, exist_ok=True)
    mp.spawn(_entry, args=(world, str(tmp / "store"), fn_name, args, str(tmp)),
             nprocs=world, join=True)
    out = []
    for r in range(world):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


# ------------------------------------------------------------------ port side

def _record_routes(routes: list):
    """Wrap the port's ``_route`` to keep each call's (ids, positions)."""
    from repro_torch.models import moe as moe_mod
    orig = moe_mod._route

    def rec(cfg, xt, wr):
        out = orig(cfg, xt, wr)
        routes.append((out[0].detach().cpu().numpy().astype(np.int64),
                       out[1].detach().cpu().numpy().astype(np.int64)))
        return out

    moe_mod._route = rec


def train_rank(rank, spec):
    """The port's sharded step on ``spec["mesh"]``: metrics per step, this
    rank's routing, the parameters gathered after the last step (rank 0)."""
    import torch
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import steps
    from repro_torch.optim import get_optimizer
    from repro_torch.runtime.elastic import make_elastic_mesh
    from repro_torch.sharding import gather_tree, shard_tree

    if spec.get("a2a"):
        os.environ["REPRO_MOE_A2A"] = "1"
    cfg = get_smoke_config(spec["arch"])
    data, model = spec["mesh"]
    mesh = make_elastic_mesh(data * model, model_parallel=model, device="cpu")
    assert mesh.shape == {"data": data, "model": model}
    with np.load(spec["init"]) as z:
        params = unflat_paths({k: torch.from_numpy(z[k].copy()) for k in z.files})
    opt = get_optimizer(cfg.optimizer)
    full = {"params": params, "opt": opt.init(params),
            "step": torch.zeros((), dtype=torch.int32)}
    state_sh = steps.state_shardings(full, mesh)
    state = shard_tree(full, state_sh)
    step = steps.make_sharded_train_step(cfg, mesh, state_sh, **STEP_KW)
    routes: list = []
    _record_routes(routes)
    metrics = []
    for _, batch in zip(range(STEPS), SyntheticLM(cfg, BATCH, SEQ, seed=0)):
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    final = gather_tree(state["params"], state_sh["params"])
    return {"coords": mesh.coords, "metrics": metrics, "routes": routes,
            "params": ({k: v.numpy() for k, v in flat_paths(final).items()}
                       if rank == 0 else None),
            "loaded": sorted(m for m in ("jax", "repro") if m in sys.modules)}


def moe_one_rank(rank):
    """ep and a2a on a 1x1 mesh with a process group (its collectives run)
    against the local path: for the output, aux and every gradient, the
    largest |difference| over the largest |local value|."""
    import torch
    from repro_torch import sharding as shd
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import moe
    from repro_torch.tree import tree_leaves, tree_unflatten

    cfg = get_smoke_config("moonshot-v1-16b-a3b")
    p = moe.moe_params(torch.Generator().manual_seed(0), cfg, torch.float32)
    x = torch.randn((2, 16, cfg.d_model), generator=torch.Generator().manual_seed(1))
    mesh = make_host_mesh(device="cpu")
    assert len(mesh.groups) == 2

    def run():
        leaves = [t.detach().requires_grad_() for t in [x] + tree_leaves(p)]
        y, aux = moe.moe_ffn(cfg, tree_unflatten(p, leaves[1:]), leaves[0])
        grads = torch.autograd.grad((y * y).sum() + aux, leaves)
        return [y, aux, *grads]

    want = run()
    out = {}
    for name in ("ep", "a2a"):
        os.environ["REPRO_MOE_A2A"] = "1" if name == "a2a" else "0"
        with shd.use_mesh(mesh):
            got = run()
        out[name] = [float((a - b).abs().max() / b.abs().max()) for a, b in zip(got, want)]
    return out


def misc_rank(rank, tmp):
    """The collectives' backward, elastic meshes and sharded checkpoints on
    4 ranks."""
    import torch
    from repro_torch import sharding as shd
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.launch import steps
    from repro_torch.launch.train import build_state
    from repro_torch.runtime.elastic import make_elastic_mesh
    from repro_torch.tree import tree_leaves

    out = {}
    mesh = make_elastic_mesh(4, model_parallel=2, device="cpu")   # (2, 2)
    m, M = mesh.index("model"), mesh.shape["model"]
    # each collective against its definition, value and gradient
    x = torch.arange(12.0).reshape(4, 3) * (m + 1)
    got = {}
    for name, fn in (("copy", lambda t: shd.copy_to_axis(t, mesh, "model")),
                     ("reduce", lambda t: shd.reduce_from_axis(t, mesh, "model")),
                     ("split", lambda t: shd.split_along(t, mesh, "model", 0)),
                     ("gather", lambda t: shd.gather_along(t, mesh, "model", 1)),
                     ("a2a", lambda t: shd.all_to_all(t.reshape(M, 2, 3), mesh, "model"))):
        t = x.clone().requires_grad_()
        y = fn(t)
        w = torch.arange(y.numel(), dtype=torch.float32).reshape(y.shape) + 10 * m
        (g,) = torch.autograd.grad((y * w).sum(), t)
        got[name] = (y.detach().numpy(), g.numpy())
    out["collectives"] = (m, got)
    # a mesh over the first 3 ranks: the fourth holds no shard
    sub = make_elastic_mesh(3, model_parallel=1, device="cpu")
    out["sub"] = None if sub is None else sub.shape
    # a sharded save on (2, 2), restored onto (4, 1)
    cfg = get_smoke_config("moonshot-v1-16b-a3b")
    full = build_state(cfg, seed=5, device="cpu")
    sh = steps.state_shardings(full, mesh)
    if rank == 1:
        # a late manager (its start sweeps .tmp_step_* dirs) must not
        # remove the writer's step in progress
        time.sleep(1)
    ckpt = CheckpointManager(str(Path(tmp) / "ckpt"))
    mine = shd.shard_tree(full, sh)
    ckpt.save(7, mine, shardings=sh)
    # back onto (2, 2), this rank's shards as the example
    again, _ = ckpt.restore(mine, shardings=sh)
    out["restore_self"] = all(torch.equal(a, b) and a.dtype == b.dtype
                              for a, b in zip(tree_leaves(again), tree_leaves(mine)))
    mesh41 = make_elastic_mesh(4, model_parallel=1, device="cpu")
    sh41 = steps.state_shardings(full, mesh41)
    back, info = ckpt.restore(full, shardings=sh41)
    want = shd.shard_tree(full, sh41)
    out["restore"] = (info["step"], all(torch.equal(a, b) and a.dtype == b.dtype
                                        for a, b in zip(tree_leaves(back), tree_leaves(want))),
                      sum(a.numel() for a in tree_leaves(back)))
    return out


# the sharded prefill / decode runs: SERVE_BATCH prompts of SERVE_PROMPT
# tokens into caches of SERVE_MAX positions, then SERVE_DECODE greedy steps
SERVE_BATCH, SERVE_PROMPT, SERVE_MAX, SERVE_DECODE = 4, 12, 16, 3
SERVE_MESHES = ((2, 1), (1, 2))


def serve_prompts(vocab: int) -> np.ndarray:
    return np.random.default_rng(7).integers(0, vocab, (SERVE_BATCH, SERVE_PROMPT),
                                             dtype=np.int32)


def serve_rank(rank, spec):
    """The port's sharded prefill and SERVE_DECODE decode steps of each
    arch of ``spec`` on each of SERVE_MESHES over the 2 ranks: this rank's
    prefill logits, greedy tokens and caches (after the prefill and after
    the last step), keyed ``"arch (data, model)"``."""
    import torch
    from repro_torch import sharding as shd
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.launch import steps

    out = {}
    for arch, init in spec["inits"].items():
        cfg = get_smoke_config(arch)
        with np.load(init) as z:
            params = unflat_paths({k: torch.from_numpy(z[k].copy()) for k in z.files})
        tokens = torch.from_numpy(serve_prompts(cfg.vocab_size))
        for data, model in SERVE_MESHES:
            mesh = shd.make_mesh((data, model), ("data", "model"), device="cpu")
            psh = shd.param_shardings(params, mesh)
            mine = shd.shard_tree(params, psh)
            prefill = steps.make_sharded_prefill_step(cfg, mesh, psh, max_seq=SERVE_MAX)
            decode = steps.make_sharded_decode_step(cfg, mesh, psh)
            logits, cache = prefill(mine, {"tokens": tokens})
            first = {k: v.numpy().copy() for k, v in flat_paths(cache).items()}
            tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
            toks = [tok.numpy()]
            for _ in range(SERVE_DECODE):
                whole = shd.all_gather(tok, mesh, ("data",), 0)
                tok, cache = decode(mine, cache, {"tokens": whole[:, None]})
                toks.append(tok.numpy())
            out[f"{arch} {(data, model)}"] = {
                "coords": mesh.coords, "logits": logits.numpy(), "tokens": toks,
                "cache_prefill": first,
                "cache_final": {k: v.numpy() for k, v in flat_paths(cache).items()}}
    out["loaded"] = sorted(m for m in ("jax", "repro") if m in sys.modules)
    return out


def run_serve(archs, tmp: Path) -> dict:
    """The reference's parameters for each arch's smoke config, its jitted
    sharded prefill and decode on SERVE_MESHES (a subprocess on 2 forced
    host devices) and the port's on 2 gloo ranks: ``{"ref", "port"}``."""
    import jax
    from repro.configs.registry import get_smoke_config
    from repro.models import model as ref_model

    tmp = Path(tmp)
    tmp.mkdir(parents=True, exist_ok=True)
    inits = {}
    for i, arch in enumerate(archs):
        params = jax.tree.map(np.asarray, ref_model.init_params(
            jax.random.PRNGKey(11 + i), get_smoke_config(arch)))
        inits[arch] = str(tmp / f"init{i}.npz")
        np.savez(inits[arch], **flat_paths(params))
    spec = {"inits": inits, "mesh": [2, 1], "out": str(tmp / "serve_ref.pkl")}
    proc = reference(spec, tmp, mode="serve_ref")
    try:
        port = spawn("serve_rank", 2, tmp / "port", spec)
    finally:
        log, _ = proc.communicate(timeout=600)
    if proc.returncode:
        raise RuntimeError(f"the reference's run failed:\n{log.decode()[-4000:]}")
    with open(spec["out"], "rb") as f:
        ref = pickle.load(f)
    return {"ref": ref, "port": port}


# ------------------------------------------------------------------ parity

def run_parity(arch: str, mesh: tuple, tmp: Path, *, a2a: bool = False) -> dict:
    """The reference's parameters for ``arch``'s smoke config, its sharded
    run on ``mesh`` (a subprocess on forced host devices) and the port's on
    as many gloo ranks, side by side: ``{"ref", "port"}`` (the port's a list
    in rank order)."""
    import jax
    from repro.configs.registry import get_smoke_config
    from repro.models import model as ref_model

    tmp = Path(tmp)
    tmp.mkdir(parents=True, exist_ok=True)
    cfg = get_smoke_config(arch)
    params = jax.tree.map(np.asarray, ref_model.init_params(jax.random.PRNGKey(3), cfg))
    np.savez(tmp / "init.npz", **flat_paths(params))
    spec = {"arch": arch, "mesh": list(mesh), "a2a": a2a, "init": str(tmp / "init.npz"),
            "out": str(tmp / "ref.pkl")}
    proc = reference(spec, tmp)
    try:
        port = spawn("train_rank", mesh[0] * mesh[1], tmp / "port", spec)
    finally:
        log, _ = proc.communicate(timeout=600)
    if proc.returncode:
        raise RuntimeError(f"the reference's run failed:\n{log.decode()[-4000:]}")
    with open(spec["out"], "rb") as f:
        ref = pickle.load(f)
    return {"ref": ref, "port": port, "init": params}


def check_parity(out: dict, *, step_tol: float, param_atol: float) -> None:
    """Each step's metrics within ``step_tol`` (relative) of the reference's
    and identical on every rank; the parameters after the last step within
    ``param_atol``; each rank's routing (expert ids and positions, so the
    kept assignments too) identical to the reference's shard at the same
    mesh coordinate (on the local path, where the reference routes the
    whole batch, to its whole batch's)."""
    ref, port = out["ref"], out["port"]
    assert len(port[0]["metrics"]) == len(ref["metrics"]) == STEPS
    for i, (pm, rm) in enumerate(zip(port[0]["metrics"], ref["metrics"])):
        assert set(pm) == set(rm) == {"loss", "ce", "aux", "gnorm", "lr"}
        for k in rm:
            np.testing.assert_allclose(pm[k], rm[k], rtol=step_tol, err_msg=f"step {i} {k}")
    for r in port[1:]:
        assert r["metrics"] == port[0]["metrics"]
    assert all(r["loaded"] == [] for r in port)   # the ranks ran without jax
    got = port[0]["params"]
    assert sorted(got) == sorted(ref["params"])
    for k, want in ref["params"].items():
        assert got[k].shape == want.shape and got[k].dtype == want.dtype, k
        np.testing.assert_allclose(got[k], want, rtol=0, atol=param_atol, err_msg=k)
    for r in port:
        mine = sorted((e.tobytes(), p.tobytes()) for e, p in r["routes"])
        theirs = ref["routes"].get(tuple(r["coords"]), ref["routes"].get("all", []))
        assert set(mine) == {(e.tobytes(), p.tobytes()) for e, p in theirs}, r["coords"]


# ------------------------------------------------------------------ reference side

def reference(spec: dict, tmp: Path, mode: str = "ref") -> subprocess.Popen:
    """Start the reference's run of ``spec`` (results in ``spec["out"]``):
    its sharded train steps (``mode="ref"``) or its sharded serving
    (``"serve_ref"``)."""
    tmp = Path(tmp)
    path = tmp / "ref_spec.json"
    path.write_text(json.dumps(spec))
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(SRC),
               XLA_FLAGS="--xla_force_host_platform_device_count=%d"
               % (spec["mesh"][0] * spec["mesh"][1]))
    env.pop("REPRO_MOE_A2A", None)
    if spec.get("a2a"):
        env["REPRO_MOE_A2A"] = "1"
    return subprocess.Popen([sys.executable, str(Path(__file__)), mode, str(path)],
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


def _reference_main(spec_path: str) -> None:
    import jax
    import jax.numpy as jnp

    from repro import sharding as shd
    from repro.configs.registry import get_smoke_config
    from repro.data.pipeline import SyntheticLM
    from repro.launch import steps
    from repro.models import moe
    from repro.optim.optimizers import get_optimizer

    spec = json.loads(Path(spec_path).read_text())
    cfg = get_smoke_config(spec["arch"])
    names = ("data", "model")
    mesh = jax.make_mesh(tuple(spec["mesh"]), names, **shd.mesh_axis_types_kw(2))
    with np.load(spec["init"]) as z:
        params = unflat_paths({k: jnp.asarray(z[k]) for k in z.files})
    routes: dict = {}

    def cb(d, m, e, p):
        routes.setdefault((int(d), int(m)), []).append(
            (np.asarray(e).astype(np.int64), np.asarray(p).astype(np.int64)))

    orig = moe._route

    def cb_all(e, p):
        routes.setdefault("all", []).append(
            (np.asarray(e).astype(np.int64), np.asarray(p).astype(np.int64)))

    def rec(cfg_, xt, wr):
        out = orig(cfg_, xt, wr)
        try:
            d, m = jax.lax.axis_index("data"), jax.lax.axis_index("model")
        except NameError:   # the local path: no shard_map, the whole batch
            jax.debug.callback(cb_all, out[0], out[1])
        else:
            jax.debug.callback(cb, d, m, out[0], out[1])
        return out

    moe._route = rec
    opt = get_optimizer(cfg.optimizer)
    state = {"params": params, "opt": opt.init(params), "step": jnp.zeros((), jnp.int32)}
    step_fn = steps.make_train_step(cfg, **STEP_KW)
    metrics = []
    with mesh:
        state_sh = steps.state_shardings(jax.eval_shape(lambda: state), mesh)
        state = jax.device_put(state, state_sh)
        batches = [b for _, b in zip(range(STEPS), SyntheticLM(cfg, BATCH, SEQ, seed=0))]
        jstep = jax.jit(step_fn, in_shardings=(state_sh, shd.batch_shardings(
            jax.eval_shape(lambda: batches[0]), mesh)),
            out_shardings=(state_sh, steps.metrics_shardings(mesh)))
        for b in batches:
            state, m = jstep(state, b)
            metrics.append({k: float(v) for k, v in m.items()})
        jax.effects_barrier()
    final = jax.tree.map(np.asarray, jax.device_get(state["params"]))
    with open(spec["out"], "wb") as f:
        pickle.dump({"metrics": metrics, "routes": routes,
                     "params": flat_paths(final)}, f)


def _reference_serve(spec_path: str) -> None:
    """The reference's jitted prefill and decode with the dry run's
    shardings (``repro/launch/dryrun.py``) for each arch and mesh."""
    import jax
    import jax.numpy as jnp

    from repro import sharding as shd
    from repro.configs.base import ShapeConfig
    from repro.configs.registry import get_smoke_config
    from repro.launch import steps

    spec = json.loads(Path(spec_path).read_text())
    out = {}
    for arch, init in spec["inits"].items():
        cfg = get_smoke_config(arch)
        with np.load(init) as z:
            params = unflat_paths({k: jnp.asarray(z[k]) for k in z.files})
        tokens = serve_prompts(cfg.vocab_size)
        for mshape in SERVE_MESHES:
            mesh = jax.make_mesh(mshape, ("data", "model"), **shd.mesh_axis_types_kw(2))
            with mesh:
                params_sh = shd.param_shardings(jax.eval_shape(lambda: params), mesh)
                p = jax.device_put(params, params_sh)
                batch = {"tokens": jnp.asarray(tokens)}
                batch_sh = shd.batch_shardings(jax.eval_shape(lambda: batch), mesh)
                cache_shapes = steps.abstract_cache(
                    cfg, ShapeConfig("serve", "decode", SERVE_MAX, SERVE_BATCH))
                cache_sh = shd.cache_shardings(cache_shapes, mesh)
                logits_sh = shd.NamedSharding(mesh, shd.data_spec(
                    jax.ShapeDtypeStruct((SERVE_BATCH, 1, cfg.vocab_size), jnp.float32), mesh))
                tok_sh = shd.NamedSharding(mesh, shd.data_spec(
                    jax.ShapeDtypeStruct((SERVE_BATCH,), jnp.int32), mesh))
                prefill = jax.jit(steps.make_prefill_step(cfg, max_seq=SERVE_MAX),
                                  in_shardings=(params_sh, batch_sh),
                                  out_shardings=(logits_sh, cache_sh))
                logits, cache = prefill(p, batch)
                first = {k: np.asarray(v) for k, v in flat_paths(jax.device_get(cache)).items()}
                tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)
                toks = [np.asarray(tok)]
                dec_batch_sh = shd.batch_shardings(jax.eval_shape(
                    lambda: {"tokens": jnp.zeros((SERVE_BATCH, 1), jnp.int32)}), mesh)
                decode = jax.jit(steps.make_decode_step(cfg),
                                 in_shardings=(params_sh, cache_sh, dec_batch_sh),
                                 out_shardings=(tok_sh, cache_sh))
                for _ in range(SERVE_DECODE):
                    tok, cache = decode(p, cache, {"tokens": tok[:, None]})
                    toks.append(np.asarray(tok))
                out[f"{arch} {tuple(mshape)}"] = {
                    "logits": np.asarray(logits), "tokens": toks, "cache_prefill": first,
                    "cache_final": {k: np.asarray(v) for k, v in
                                    flat_paths(jax.device_get(cache)).items()}}
    with open(spec["out"], "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__" and len(sys.argv) == 3 and sys.argv[1] in ("ref", "serve_ref"):
    sys.path.insert(0, str(SRC))
    {"ref": _reference_main, "serve_ref": _reference_serve}[sys.argv[1]](sys.argv[2])

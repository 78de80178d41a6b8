"""The training mesh's rules and single-process pieces against the reference:
the name-to-axis specs (``param_spec``, ``opt_state_shardings``,
``cache_spec``, ``data_spec``) tuple for tuple for all ten architectures at
full size on the production meshes, an elastic one and 1x1, and on the
port's own smoke states; ``plan_elastic_mesh``; int8 gradient compression
with error feedback, bit for bit against eager ``repro``; the expert-parallel
MoE paths at 1x1 against the local path; the meshes' refusals.

Tolerances: specs, plans and compression exact; the MoE paths at 1x1 within
``tests/test_sharding_moe.py``'s bounds of the reference (rtol / atol 2e-5,
aux rtol 1e-4) and equal to the port's local path.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

import torch_mesh_ranks as ranks
from repro import sharding as ref_shd
from repro.configs.base import SHAPES, shape_applicable
from repro.configs.registry import ARCH_IDS, get_config
from repro.configs.registry import get_smoke_config as ref_smoke_config
from repro.launch import steps as ref_steps
from repro.launch.mesh import make_host_mesh as ref_host_mesh
from repro.launch.mesh import make_production_mesh as ref_production_mesh
from repro.models import moe as ref_moe
from repro.runtime import compression as ref_comp
from repro.runtime import elastic as ref_elastic
from repro_torch import sharding as shd
from repro_torch.configs.registry import get_smoke_config
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.launch.train import build_state
from repro_torch.models import moe
from repro_torch.runtime import compression, elastic
from repro_torch.tree import tree_leaves, tree_map_with_path

MESHES = {
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "elastic496": ref_elastic.plan_elastic_mesh(496),   # (31, 16)
    "1x1": ((1, 1), ("data", "model")),
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _meshes(name):
    shape, names = MESHES[name]
    return ref_shd.abstract_mesh(shape, names), shd.AbstractMesh(shape, names)


def _ref_specs(tree):
    """{key path: spec tuple} of a tree of NamedSharding or PartitionSpec."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, (jax.sharding.NamedSharding,
                                               jax.sharding.PartitionSpec)))[0]
    return {tuple(str(k.key) for k in path):
            tuple(getattr(leaf, "spec", leaf)) for path, leaf in flat}


def _port_specs(tree):
    out = {}
    tree_map_with_path(lambda path, leaf: out.__setitem__(
        path, tuple(getattr(leaf, "spec", leaf))), tree)
    return out


@functools.lru_cache(maxsize=None)
def _abstract(arch):
    cfg = get_config(arch)
    state = ref_steps.abstract_state(cfg)
    shapes = {n: s for n, s in SHAPES.items() if shape_applicable(cfg, s)[0]}
    return (state, {n: ref_steps.abstract_cache(cfg, s) for n, s in shapes.items()},
            {n: ref_steps.input_specs(cfg, s) for n, s in shapes.items()})


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_match_reference_at_full_size(arch, mesh_name):
    ref_mesh, mesh = _meshes(mesh_name)
    state, caches, inputs = _abstract(arch)
    want = _ref_specs(ref_steps.state_shardings(state, ref_mesh))
    got = _port_specs(steps.state_shardings(state, mesh))
    assert got == want
    assert any("model" in str(s) for s in got.values()) or mesh_name == "1x1"
    for name, cache in caches.items():
        want = _ref_specs(jax.tree_util.tree_map_with_path(
            lambda p, leaf: ref_shd.cache_spec(p, leaf, ref_mesh), cache))
        assert _port_specs(shd.cache_shardings(cache, mesh)) == want, name
    for name, specs in inputs.items():
        for key, leaf in specs.items():
            assert tuple(shd.data_spec(leaf.shape, mesh)) == \
                tuple(ref_shd.data_spec(leaf, ref_mesh)), (name, key)


@pytest.fixture(scope="module")
def smoke_states():
    return {}


@pytest.mark.parametrize("mesh_shape", [(2, 2), (1, 4), (4, 1)])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_of_the_ports_own_smoke_state(arch, mesh_shape, smoke_states):
    if arch not in smoke_states:
        smoke_states[arch] = build_state(get_smoke_config(arch), device="cpu")
    state = smoke_states[arch]
    names = ("data", "model")
    want = _ref_specs(ref_steps.state_shardings(
        ref_steps.abstract_state(ref_smoke_config(arch)),
        ref_shd.abstract_mesh(mesh_shape, names)))
    got = _port_specs(steps.state_shardings(state, shd.AbstractMesh(mesh_shape, names)))
    assert got == want


@pytest.mark.parametrize("mesh_shape", [(1, 1), (1, 3), (2, 3), (4, 2), (16, 16)])
@pytest.mark.parametrize("arch", [a for a in ARCH_IDS if get_config(a).n_experts])
def test_expert_split_is_one_decision(arch, mesh_shape):
    # the MoE dispatch (the reference's test, moe.py:107), the rules' spec of
    # every expert leaf and the step's kept axes agree
    cfg = get_config(arch)
    mesh = shd.AbstractMesh(mesh_shape, ("data", "model"))
    E, M = cfg.n_experts, mesh_shape[1]
    assert shd.experts_split(mesh, E) == (E % M == 0)
    for name, tail in (("wei", (cfg.d_model, cfg.d_ff)), ("weo", (cfg.d_ff, cfg.d_model))):
        for lead in ((), (4,), (2, 4)):
            path = ("blocks", "moe", name)
            sh = shd.NamedSharding(mesh, shd.param_spec(path, lead + (E,) + tail, mesh))
            assert shd.expert_axes(path, sh) == (("model",) if E % M == 0 else ())
    assert shd.expert_axes(("blocks", "attn", "wq"),
                           shd.NamedSharding(mesh, shd.P("data", "model"))) == ()


@pytest.mark.parametrize("prefer_pods", [True, False])
@pytest.mark.parametrize("model_parallel", [1, 2, 4, 8, 16])
def test_plan_elastic_mesh_matches_reference(model_parallel, prefer_pods):
    for n in range(1, 1025):
        kw = dict(model_parallel=model_parallel, prefer_pods=prefer_pods)
        try:
            want = ref_elastic.plan_elastic_mesh(n, **kw)
        except ValueError as e:
            with pytest.raises(ValueError, match=str(e)):
                elastic.plan_elastic_mesh(n, **kw)
            continue
        assert elastic.plan_elastic_mesh(n, **kw) == want, n


def _grad_tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": {"w": rng.normal(0, 1e-3, (33, 17)).astype(np.float32),
                  "b": rng.normal(0, 5.0, (7,)).astype(np.float32)},
            "z": np.zeros((4, 4), np.float32),
            "h": (rng.normal(0, 1e-2, (9, 5)).astype(np.float32)
                  .astype(jnp.bfloat16))}


def test_compress_grads_matches_reference_bit_for_bit():
    ref_err = ref_comp.init_compression_state(
        jax.tree.map(jnp.asarray, _grad_tree(0)))
    err = compression.init_compression_state(
        {"a": {"w": torch.zeros(33, 17), "b": torch.zeros(7)}, "z": torch.zeros(4, 4),
         "h": torch.zeros(9, 5, dtype=torch.bfloat16)})
    for r in range(3):   # error feedback: each round carries the residual
        g = _grad_tree(r + 1)
        rq, rs, ref_err = ref_comp.compress_grads(jax.tree.map(jnp.asarray, g), ref_err)
        tg = jax.tree.map(lambda a: torch.from_numpy(np.asarray(a, np.float32)), g)
        tg["h"] = tg["h"].to(torch.bfloat16)
        q, s, err = compression.compress_grads(tg, err)
        for want, got in ((rq, q), (rs, s), (ref_err, err)):
            for a, b in zip(jax.tree.leaves(want), tree_leaves(got)):
                assert str(b.dtype)[6:] == str(a.dtype)
                np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        back = compression.decompress_grads(q, s)
        for a, b in zip(jax.tree.leaves(ref_comp.decompress_grads(rq, rs)), tree_leaves(back)):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert int(q["z"].abs().max()) == 0 and int(q["a"]["w"].abs().max()) == 127
    want = ref_comp.compression_ratio(jax.tree.map(jnp.asarray, _grad_tree(0)))
    assert compression.compression_ratio(tg) == want


def _moe_inputs():
    cfg = ref_smoke_config("moonshot-v1-16b-a3b").replace(n_experts=4, experts_per_token=2)
    p = ref_moe.moe_params(jax.random.PRNGKey(0), cfg, jnp.float32)
    x = jax.random.normal(jax.random.PRNGKey(1), (2, 16, cfg.d_model))
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), p)
    port_cfg = get_smoke_config("moonshot-v1-16b-a3b").replace(n_experts=4,
                                                                 experts_per_token=2)
    return cfg, p, x, port_cfg, tp, torch.from_numpy(np.array(x))


@pytest.mark.parametrize("a2a", [False, True])
def test_moe_paths_at_1x1_equal_the_local_path(a2a, monkeypatch):
    cfg, p, x, port_cfg, tp, tx = _moe_inputs()
    y_ref, aux_ref = ref_moe.moe_ffn(cfg, p, x)          # the reference's local path
    with ref_host_mesh():
        y_sm, aux_sm = jax.jit(lambda p, x: ref_moe.moe_ffn(cfg, p, x))(p, x)
    y_local, aux_local = moe.moe_ffn(port_cfg, tp, tx)
    if a2a:
        monkeypatch.setenv("REPRO_MOE_A2A", "1")
    calls = {"ep": 0, "a2a": 0}
    for name in calls:
        fn = getattr(moe, f"_moe_ffn_{name}")
        monkeypatch.setattr(moe, f"_moe_ffn_{name}",
                            lambda *a, _f=fn, _n=name: calls.__setitem__(_n, calls[_n] + 1)
                            or _f(*a))
    with shd.use_mesh(make_host_mesh(device="cpu")):
        y, aux = moe.moe_ffn(port_cfg, tp, tx)
    assert calls == ({"ep": 0, "a2a": 1} if a2a else {"ep": 1, "a2a": 0})
    assert shd.ambient_mesh() is None
    for want, want_aux in ((y_ref, aux_ref), (y_sm, aux_sm)):
        np.testing.assert_allclose(y.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-4)
    assert torch.equal(y, y_local) and torch.equal(aux, aux_local)


def test_moe_paths_through_a_one_rank_group(tmp_path):
    """At 1x1 with a process group the collectives run (gloo, one rank):
    output, aux and gradients within 2e-5 of the local path's (relative to
    each one's largest value; a gathered cotangent's layout changes the
    order of one sum: ``ln/scale``'s gradient, 3.8e-6 measured)."""
    (out,) = ranks.spawn("moe_one_rank", 1, tmp_path)
    for name in ("ep", "a2a"):
        assert len(out[name]) == 8 and max(out[name]) <= 2e-5, (name, out[name])
    assert out["ep"][:2] == [0.0, 0.0] and out["a2a"][:2] == [0.0, 0.0]


def test_meshes_refuse_what_they_cannot_build():
    with pytest.raises(ValueError, match="needs 256 ranks"):
        make_production_mesh(device="cpu")
    with pytest.raises(ValueError, match="needs 512 ranks"):
        make_production_mesh(multi_pod=True, device="cpu")
    with pytest.raises(ValueError, match=r"\(16, 16\)"):
        ref_production_mesh()
    with pytest.raises(RuntimeError, match="needs 4 ranks"):
        shd.make_mesh((2, 2), ("data", "model"), device="cpu")
    if not torch.cuda.is_available():   # no card: no CPU fallback
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_host_mesh()
    mesh = make_host_mesh(device="cpu")
    assert mesh.shape == {"data": 1, "model": 1} and mesh.groups == ()
    assert mesh.coords == (0, 0) and mesh.device == torch.device("cpu")
    with shd.use_mesh(mesh):
        with shd.use_mesh(None):
            assert shd.ambient_mesh() is None
        assert shd.ambient_mesh() is mesh
    assert shd.ambient_mesh() is None

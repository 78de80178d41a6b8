"""bfloat16 leaves through the port's ``CheckpointManager``: saved as their
raw 16-bit words (a ``.npy`` of 2-byte items, meta ``"bfloat16"``, the ECC
sidecar over the same words), so that either package restores the other's
checkpoint, bit for bit.  The reference restores with its default
``verify=True``: its ``verify=False`` path casts the 2-byte items it loads
to bfloat16, which numpy refuses.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.checkpoint import CheckpointManager as RefManager
from repro_torch.checkpoint import CheckpointManager
from repro_torch.optim.optimizers import adafactor


def _state():
    return {"a": torch.ones(3, dtype=torch.bfloat16), "b": torch.zeros(2)}


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()


def test_port_save_restores_in_the_reference(tmp_path):
    state = {"a": torch.tensor([1.0, -2.5, 3.0e-3], dtype=torch.bfloat16),
             "b": torch.zeros(2)}
    CheckpointManager(str(tmp_path)).save(1, state, device="cpu")
    meta = json.loads((tmp_path / "step_1" / "meta.json").read_text())
    assert [leaf["dtype"] for leaf in meta["leaves"]] == ["bfloat16", "float32"]
    assert meta["leaves"][0]["nbytes"] == 6
    example = {"a": jnp.zeros(3, jnp.bfloat16), "b": jnp.ones(2, jnp.float32)}
    got, info = RefManager(str(tmp_path)).restore(example)
    assert info == {"step": 1, "corrected_codewords": 0}
    a = np.asarray(got["a"])
    assert a.dtype.name == "bfloat16"
    np.testing.assert_array_equal(a.view(np.int16), _bits(state["a"]))
    np.testing.assert_array_equal(np.asarray(got["b"]), state["b"].numpy())


def test_reference_save_restores_in_the_port(tmp_path):
    words = np.array([0x3F80, 0xC020, 0x3B44], dtype=np.uint16).view(np.int16)   # 1, -2.5, ~3e-3
    ref_a = jnp.asarray(words.view(jnp.bfloat16))
    RefManager(str(tmp_path)).save(4, {"a": ref_a, "b": jnp.zeros(2)})
    got, info = CheckpointManager(str(tmp_path)).restore(_state(), device="cpu")
    assert info == {"step": 4, "corrected_codewords": 0}
    assert got["a"].dtype == torch.bfloat16 and got["a"].device.type == "cpu"
    np.testing.assert_array_equal(_bits(got["a"]), words)
    assert torch.equal(got["b"], torch.zeros(2))
    # the same words without the sidecar check (the plain np.load path)
    plain, _ = CheckpointManager(str(tmp_path)).restore(_state(), device="cpu",
                                                        verify=False)
    np.testing.assert_array_equal(_bits(plain["a"]), words)


@pytest.mark.parametrize("protect", [True, False])
def test_port_round_trip(tmp_path, protect):
    rng = np.random.default_rng(0)
    state = {"a": torch.from_numpy(rng.normal(0, 3, (5, 7)).astype(np.float32))
             .to(torch.bfloat16),
             "b": {"c": torch.arange(4, dtype=torch.int32),
                   "d": torch.ones(2, 3, dtype=torch.bfloat16) * -0.0}}
    mgr = CheckpointManager(str(tmp_path), protect=protect)
    mgr.save(2, state, device="cpu")
    assert (tmp_path / "step_2" / "leaf_0.ecc.npy").exists() == protect
    got, _ = mgr.restore(state, device="cpu")
    for key, want in (("a", state["a"]), ("c", state["b"]["c"]), ("d", state["b"]["d"])):
        have = got[key] if key == "a" else got["b"][key]
        assert have.dtype == want.dtype and have.shape == want.shape
        np.testing.assert_array_equal(_bits(have), _bits(want))   # -0.0 kept too


def test_adafactor_momentum_state_round_trip(tmp_path):
    """Adafactor with ``momentum=True`` keeps a bfloat16 first moment ``m``."""
    opt = adafactor(momentum=True)
    params = {"w": torch.ones(4, 6), "n": torch.ones(6)}
    state = opt.init(params)
    grads = {"w": torch.linspace(-1, 1, 24).reshape(4, 6), "n": torch.full((6,), 0.3)}
    _, state = opt.update(grads, state, params, 0.01)
    assert state["f"]["w"]["m"].dtype == torch.bfloat16
    assert bool(state["f"]["w"]["m"].ne(0).any())
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, state, device="cpu")
    got, _ = mgr.restore(opt.init(params), device="cpu")
    for name in ("w", "n"):
        for key, want in state["f"][name].items():
            have = got["f"][name][key]
            assert have.dtype == want.dtype
            np.testing.assert_array_equal(_bits(have), _bits(want))
    assert int(got["count"]) == int(state["count"])

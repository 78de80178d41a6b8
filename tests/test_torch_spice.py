"""Port parity of the Appendix B circuit model: ``repro_torch.core.spice``
(an eager torch loop of the reference's Euler step) against
``repro.core.spice`` (a jitted ``lax.scan``), on the CPU.

Tolerance: traces (``v_sa``, ``v_probe``, ``v_cell``) and
``restored_voltage`` within 3e-6 V.  The port divides by the time constants
(IEEE float32 division, ``latency.div_t``'s convention) where the reference's
jitted scan multiplies by reciprocals, and torch's tanh is not XLA's; the
regenerative sense amp carries those ulps for a while (measured: at most
2.03e-6 V at a mid-restore step, 0 at most steps).  Sense and precharge times
are read on the same Euler step, so they are identical, and so are the fitted
coefficients."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.core import spice as rspice
from repro_torch.core import spice as tspice

V_ATOL = 3e-6
ROWS = np.array([[0.05], [0.5], [0.95]], np.float32)   # (3, 1)
COLS = np.array([[0.0, 1.0]], np.float32)              # (1, 2) -> (3, 2) cells
RUNS = {"default": {}, "precharge_at_12": dict(t_precharge_at_ns=12.0),
        "uncharged": dict(cell_charged=False)}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These tensors are small: one intra-op thread runs them as fast and
    leaves the host's cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=sorted(RUNS))
def runs(request):
    kw = RUNS[request.param]
    return (tspice.simulate(ROWS, COLS, device="cpu", **kw),
            rspice.simulate(jnp.asarray(ROWS), jnp.asarray(COLS), **kw), kw)


def test_circuit_params_carry_across():
    ref = rspice.CircuitParams()
    port = tspice.CircuitParams(**dataclasses.asdict(ref))
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.tau_seg_ns == ref.tau_seg_ns


def test_simulate_traces_match_reference(runs):
    got, want, _ = runs
    np.testing.assert_array_equal(got["t_ns"], want["t_ns"])
    assert got["t_ns"].dtype == np.float64
    for k in ("v_sa", "v_probe", "v_cell"):
        assert got[k].dtype == torch.float32
        assert tuple(got[k].shape) == (3, 2, 4500)
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=V_ATOL, err_msg=k)


def test_read_out_helpers_match_reference(runs):
    got, want, kw = runs
    t_pre = kw.get("t_precharge_at_ns", 30.0)
    np.testing.assert_array_equal(tspice.sense_time(got),
                                  rspice.sense_time(want))
    np.testing.assert_array_equal(tspice.precharge_time(got, t_pre),
                                  rspice.precharge_time(want, t_pre))
    np.testing.assert_array_equal(tspice.precharge_time(got, t_pre, tol=0.05),
                                  rspice.precharge_time(want, t_pre, tol=0.05))
    np.testing.assert_allclose(tspice.restored_voltage(got, t_pre),
                               rspice.restored_voltage(want, t_pre),
                               rtol=0, atol=V_ATOL)
    if not kw.get("cell_charged", True):   # never reaches 0.9 V
        assert np.isinf(tspice.sense_time(got)).all()


def test_fit_latency_coefficients_match_reference():
    got = tspice.fit_latency_coefficients(device="cpu")
    assert got == rspice.fit_latency_coefficients()
    assert got["t0_ns"] == pytest.approx(7.63)
    assert got["k_bl_ns"] > got["k_wl_ns"] > 0


def test_appendix_b_directions():
    """Fig 21: farther cells sense later, restore less, precharge slower."""
    res = tspice.simulate(np.array([0.05, 0.95]), np.array([0.0, 0.0]),
                          t_precharge_at_ns=12.0, device="cpu")
    rv = tspice.restored_voltage(res, 12.0)
    assert rv[0] > rv[1]
    full = tspice.simulate(np.array([0.05, 0.95, 0.05]),
                           np.array([0.0, 0.0, 1.0]), device="cpu")
    ts = tspice.sense_time(full)
    assert ts[1] > ts[0] and ts[2] > ts[0]
    pt = tspice.precharge_time(full, tol=0.05)
    assert pt[1] > pt[0]


def test_euler_stability_check():
    with pytest.raises(ValueError, match="stability"):
        tspice.simulate([0.5], [0.5], cp=tspice.CircuitParams(dt_ns=0.1),
                        device="cpu")

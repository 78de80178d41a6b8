"""The port's ``rc_transient`` wrapper on CPU tensors (its plain version)
against the reference's oracle (``repro.kernels.ref.rc_transient``, the
traces of ``spice.simulate``) and its Pallas kernel in interpret mode, and the
wrapper's argument checks and device dispatch.  The CUDA kernel against the
plain version is in test_torch_kernels_cuda.py.

Tolerance: ``v_probe``/``v_cell`` within 1e-6 V; ``sense_t`` on the same
Euler step (|difference| < dt/2: the reference states the crossing time in
float64, the port as ``float32(i) * dt``), and ``inf`` exactly where the
reference has ``inf``.  The reference's jitted scan divides by the time
constants through reciprocals and has its own tanh; measured on these inputs
the gap is at most 3.6e-7 V (v_cell) and 0 (v_probe).  One configuration
needs more: with 8 segments and the wordline closing at 12 ns, ``v_cell``
freezes mid-restore, where the traces differ most (tests/test_torch_spice.py
holds the traces to 3e-6 V); its ``v_cell`` is held to that 3e-6 V
(2.03e-6 measured)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.spice import CircuitParams as RefCircuitParams
from repro.kernels import ref as jref
from repro.kernels.rc_transient import rc_transient as pallas_rc_transient
from repro_torch.core.spice import (CircuitParams, divisors, n_steps,
                                    step_phases, step_times)
from repro_torch.kernels import ops
from repro_torch.kernels.rc_transient import (fast_route, launch_divisors,
                                              phase_bounds, rc_transient,
                                              rc_transient_ref)

V_ATOL = 1e-6
MID_RESTORE_ATOL = 3e-6
DT = CircuitParams().dt_ns
CASES = {"default": dict(n_seg=8, kw={}),
         "uncharged": dict(n_seg=8, kw=dict(cell_charged=False)),
         "n_seg4_tpre12": dict(n_seg=4, kw=dict(t_pre_ns=12.0)),
         "tpre12": dict(n_seg=8, kw=dict(t_pre_ns=12.0),
                        v_cell_atol=MID_RESTORE_ATOL)}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These tensors are small: one intra-op thread runs them as fast and
    leaves the host's cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cells(n: int):
    if n == 4:   # the reference's own kernel test inputs
        return (np.linspace(0.02, 0.98, n).astype(np.float32),
                np.linspace(0.0, 1.0, n).astype(np.float32))
    rng = np.random.default_rng(n)
    return (rng.uniform(0, 1, n).astype(np.float32),
            rng.uniform(0, 1, n).astype(np.float32))


def _params(n_seg: int):
    ref = RefCircuitParams(n_seg=n_seg)
    return ref, CircuitParams(**dataclasses.asdict(ref))


def _port(rf, cf, cp, **kw):
    out = rc_transient(torch.as_tensor(rf), torch.as_tensor(cf), cp=cp, **kw)
    assert all(v.dtype == torch.float32 and v.shape == (len(rf),)
               for v in out.values())
    return {k: v.numpy() for k, v in out.items()}


def _close(got: dict, want: dict, v_cell_atol: float = V_ATOL):
    for k, atol in (("v_probe", V_ATOL), ("v_cell", v_cell_atol)):
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=0,
                                   atol=atol, err_msg=k)
    ts, ref_ts = got["sense_t"], np.asarray(want["sense_t"], np.float64)
    np.testing.assert_array_equal(np.isinf(ts), np.isinf(ref_ts))
    fin = np.isfinite(ref_ts)
    assert np.all(np.abs(ts[fin] - ref_ts[fin]) < DT / 2)


@pytest.mark.parametrize("n", [4, 130, 512])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_version_matches_reference_oracle(n, case):
    ref_cp, cp = _params(CASES[case]["n_seg"])
    kw = CASES[case]["kw"]
    rf, cf = _cells(n)
    got = _port(rf, cf, cp, **kw)
    _close(got, jref.rc_transient(rf, cf, cp=ref_cp, **kw),
           CASES[case].get("v_cell_atol", V_ATOL))
    if not kw.get("cell_charged", True):   # never reaches 0.9 V
        assert np.isinf(got["sense_t"]).all()
    else:
        assert np.isfinite(got["sense_t"]).all()


@pytest.mark.parametrize("n", [4, 130, 512])
@pytest.mark.parametrize("case", ["default", "n_seg4_tpre12"])
def test_plain_version_matches_pallas_kernel(n, case):
    ref_cp, cp = _params(CASES[case]["n_seg"])
    kw = CASES[case]["kw"]
    rf, cf = _cells(n)
    _close(_port(rf, cf, cp, **kw),
           pallas_rc_transient(rf, cf, cp=ref_cp, interpret=True, **kw))


def test_sense_time_monotone_in_distance():
    rf = np.linspace(0.05, 0.95, 8).astype(np.float32)
    out = _port(rf, np.zeros(8, np.float32), CircuitParams())
    assert np.all(np.diff(out["sense_t"]) >= 0)
    far = _port(np.full(2, 0.5, np.float32), np.array([0.0, 1.0], np.float32),
                CircuitParams())
    assert far["sense_t"][1] > far["sense_t"][0]   # wordline direction


def test_plain_version_is_the_oracle_on_any_n_seg():
    """The plain version runs any ladder length the reference does (the
    kernel is instantiated at 4, 8 and 16 only)."""
    ref_cp, cp = _params(5)
    rf, cf = _cells(130)
    out = rc_transient_ref(torch.as_tensor(rf), torch.as_tensor(cf), cp=cp)
    _close({k: v.numpy() for k, v in out.items()},
           jref.rc_transient(rf, cf, cp=ref_cp))


def test_wrapper_checks_inputs():
    x = torch.zeros(4)
    with pytest.raises(TypeError, match="tensor"):
        rc_transient(np.zeros(4, np.float32), x)
    with pytest.raises(ValueError, match="float32"):
        rc_transient(x.double(), x)
    with pytest.raises(ValueError, match=r"\(N,\)"):
        rc_transient(torch.zeros((2, 2)), torch.zeros((2, 2)))
    with pytest.raises(ValueError, match="shape"):
        rc_transient(x, torch.zeros(5))
    with pytest.raises(ValueError, match="stability"):
        rc_transient(x, x, cp=CircuitParams(dt_ns=0.1))
    with pytest.raises(ValueError, match="no Euler step"):
        rc_transient(x, x, t_total_ns=0.001)


def test_cpu_tensors_launch_nothing_and_ops_lists_the_kernel():
    assert ops.KERNELS["rc_transient"] is rc_transient
    ops.reset_launches()
    out = rc_transient(torch.linspace(0, 1, 3), torch.linspace(0, 1, 3),
                       t_total_ns=1.0)
    assert set(out) == {"v_probe", "v_cell", "sense_t"}
    assert ops.launch_counts()["rc_transient"] == 0
    empty = rc_transient(torch.zeros(0), torch.zeros(0), t_total_ns=1.0)
    assert all(v.shape == (0,) for v in empty.values())


# ------------------------------------------------ the kernel's host-side set-up

PHASE_CASES = {"default": (CircuitParams(), 45.0, 30.0),
               "n_seg4_tpre12": (CircuitParams(n_seg=4), 45.0, 12.0),
               "n_seg16_dt004": (CircuitParams(n_seg=16, dt_ns=0.004), 45.0, 30.0),
               "n_seg16_dt004_20ns": (CircuitParams(n_seg=16, dt_ns=0.004), 20.0, 30.0),
               "precharge_from_0": (CircuitParams(), 5.0, 0.0),
               "sense_after_precharge": (CircuitParams(sa_enable_ns=40.0), 45.0, 30.0)}


@pytest.mark.parametrize("case", sorted(PHASE_CASES))
def test_phase_bounds_equal_step_phases_step_for_step(case):
    """The kernel's step ranges [0, i_sa), [i_sa, i_pre), [i_pre, steps) give
    every step the phases core/spice.step_phases gives its float32 time."""
    cp, t_total, t_pre = PHASE_CASES[case]
    i_sa, i_pre, steps = phase_bounds(cp, t_total, t_pre)
    assert 0 <= i_sa <= i_pre <= steps == n_steps(cp, t_total)
    for i, t in enumerate(step_times(cp, t_total)):
        assert step_phases(t, cp, t_pre) == (i < i_pre, i_sa <= i < i_pre,
                                             i >= i_pre), i


def test_launch_divisors_are_the_plain_versions_divisors():
    for cp in (CircuitParams(), CircuitParams(n_seg=4),
               CircuitParams(n_seg=16, dt_ns=0.004)):
        div = divisors(cp, "cpu")
        want = [div[k].item() for k in ("tau_seg", "wl_slope", "tau_acc_cell",
                                        "tau_acc_node", "precharge_tau")]
        got = launch_divisors(cp)
        assert got.dtype == np.float32 and got.tolist() == want


def test_fast_route_holds_for_the_launched_circuits_only():
    for cp, t_total in ((CircuitParams(), 45.0), (CircuitParams(n_seg=4), 45.0),
                        (CircuitParams(n_seg=16, dt_ns=0.004), 20.0)):
        assert fast_route(cp, t_total)
    assert not fast_route(CircuitParams(vdd=2.0 ** 40), 45.0)
    assert not fast_route(CircuitParams(v_half=-0.1), 45.0)
    assert not fast_route(CircuitParams(v_half=2.0), 45.0)   # above vdd
    tiny_tau = CircuitParams(r_bl_kohm=1e-3, c_bl_fF=1e-3, dt_ns=1e-12)
    assert launch_divisors(tiny_tau)[0] < 2.0 ** -20   # tau_seg
    assert not fast_route(tiny_tau, 1e-10)

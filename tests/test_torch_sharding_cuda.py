"""The DIMM axis split over a repeated card, on the card: ``DimmMesh([cuda:0]
* 2)`` against ``DimmMesh([cuda:0])``, each shard through the hand-written
kernels.  Skips without a CUDA device.  The file imports nothing of the JAX
reference, so it runs on a GPU host without JAX:

    python -m pytest -q -m cuda tests/test_torch_sharding_cuda.py

Tiers: tables, counts, signatures, memsim totals, hot cells and fail maps
identical; per-DIMM float sums (row lambdas, fleet lambdas) within rtol
1e-5: torch's CUDA reductions choose how to split a sum by its output count,
so a shard of 4 DIMMs may add a DIMM's cells in another order than one of 7;
the fleet cell-sum adds the shards' partials, rtol 1e-6.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.geometry import TINY
from repro_torch.core.population import make_population
from repro_torch.core.shuffling import design_stripe_profiles
from repro_torch.core.streaming import stream_error_summary
from repro_torch.core.substrate import (DimmBatch, profile_population_arrays,
                                        row_error_lambda,
                                        shuffling_gain_population)
from repro_torch.discovery.signatures import bit_signature_population
from repro_torch.kernels import ops
from repro_torch.memsim.sim import system_speedup_population
from repro_torch.sharding import DimmMesh

LAMBDA_RTOL, GRID_SUM_RTOL = 1e-5, 1e-6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_two_shards_on_one_card_equal_one(cuda):
    batch = DimmBatch.from_population(make_population(TINY, 7), cuda)
    one, two = DimmMesh([cuda]), DimmMesh([cuda] * 2)
    runs = []
    for mesh in (one, two):
        ops.reset_launches()
        tables = profile_population_arrays(batch, multibit_only=True,
                                           mesh=mesh)
        runs.append(dict(
            tables=tables,
            lam=row_error_lambda(batch, "trp", 7.5, refresh_ms=256.0,
                                 mesh=mesh),
            gain=shuffling_gain_population(design_stripe_profiles(7),
                                           n_accesses=200, mesh=mesh),
            summary=stream_error_summary(batch, "tras", 25.0, chunk_size=4,
                                         vdd=1.20, refresh_ms=256.0,
                                         retention=True,
                                         collect_fail_maps=True, mesh=mesh),
            sigs=bit_signature_population(
                np.random.default_rng(0).poisson(3.0, (7, 2, 64)), mesh=mesh),
            totals=system_speedup_population(
                tables, n_requests=400, mesh=mesh)["total_latency_cycles"],
            launches=ops.launch_counts()))
    a, b = runs
    for name in ("fail_prob_rows", "fail_prob_op", "secded_syndrome",
                 "diva_shuffle", "bit_signature", "bank_sched"):
        assert a["launches"][name] > 0 and \
            b["launches"][name] == 2 * a["launches"][name], name
    np.testing.assert_array_equal(b["tables"], a["tables"])
    np.testing.assert_allclose(b["lam"], a["lam"], rtol=LAMBDA_RTOL, atol=1e-6)
    for k in a["gain"]:
        np.testing.assert_array_equal(b["gain"][k], a["gain"][k], err_msg=k)
    np.testing.assert_array_equal(b["sigs"], a["sigs"])
    np.testing.assert_array_equal(b["totals"], a["totals"])
    s_a, s_b = a["summary"], b["summary"]
    np.testing.assert_array_equal(s_b["hot_cells"], s_a["hot_cells"])
    for p, q in zip(s_b["fail_maps"], s_a["fail_maps"]):
        np.testing.assert_array_equal(p.bits, q.bits)
    np.testing.assert_allclose(s_b["lam_total"], s_a["lam_total"],
                               rtol=LAMBDA_RTOL)
    np.testing.assert_allclose(s_b["grid_sum"], s_a["grid_sum"],
                               rtol=GRID_SUM_RTOL)

"""Port parity of blind discovery: signatures, scramble recovery, generation
clustering, the BlindDiva pipeline and blind-vs-oracle profiling of
repro_torch against repro on the reference's discovery campaign
(``campaign_counts(make_population(SMALL, 6))``: integer counts and float64
expectations carried across as numpy), on the CPU.

Everything is a decision, an integer or a float computed from identical
integers in identical operations, so it must be identical.  The exception is
the port's own ``campaign_counts``: its lambdas differ from the jitted
reference's by about an ulp (tests/test_torch_substrate.py), so ``expected``
holds to rtol 5e-5 — and the numpy Poisson draws on those lambdas are not
identical (ROADMAP queue 3); with the reference's lambdas they are.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import geometry as rgeom
from repro.core import substrate as rsub
from repro.core.population import make_population as ref_make_population
from repro.discovery import blind as rblind
from repro.discovery import generation as rgen
from repro.discovery import recover as rrec
from repro.discovery import signatures as rsig
from repro_torch.core import geometry as tgeom
from repro_torch.core import substrate as tsub
from repro_torch.core.population import make_population
from repro_torch.discovery import blind as tblind
from repro_torch.discovery import generation as tgen
from repro_torch.discovery import recover as trec
from repro_torch.discovery import signatures as tsig
from repro_torch.kernels import ops


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These tensors are small: one intra-op thread runs them as fast and
    leaves the host's cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

N_DIMMS = 6
LAMBDA_RTOL = 5e-5
FIELDS = ("serials", "labels", "ext_rows", "ext_to_int", "confidence",
          "canonical", "vuln_rows")


@pytest.fixture(scope="module")
def campaign():
    pop = ref_make_population(rgeom.SMALL, N_DIMMS)
    ref = rsub.DimmBatch.from_population(pop)
    counts, expected = rblind.campaign_counts(pop, ref)
    leaves = {k: np.asarray(getattr(ref, k)) for k in rsub._LEAVES}
    port = tsub.DimmBatch.from_arrays(dataclasses.asdict(ref.geom), leaves,
                                      device="cpu")
    return ref, port, counts, expected


@pytest.fixture(scope="module")
def discoveries(campaign):
    ref, _, counts, expected = campaign
    serials = np.asarray(ref.serial)
    return (rblind.BlindDiva().discover(counts, expected, serials=serials),
            tblind.BlindDiva().discover(counts, expected, serials=serials,
                                        device="cpu"))


def _same_dict(got: dict, want: dict):
    assert set(want) <= set(got)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("t", [0, 1, 2])
def test_signatures_identical(campaign, t):
    _, _, counts, _ = campaign
    got = tsig.bit_signature_population(counts[t], device="cpu")
    want = rsig.bit_signature_population(counts[t])
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tsig.signature_features(got),
                                  rsig.signature_features(want))


@pytest.mark.parametrize("t", [0, 1, 2])
def test_recovery_identical_to_reference_and_loop(campaign, t):
    _, _, counts, expected = campaign
    ops.reset_launches()
    got = trec.recover_mapping_population(counts[t], expected[t],
                                          device="cpu")
    assert set(ops.launch_counts().values()) == {0}
    _same_dict(got, rrec.recover_mapping_population(counts[t], expected[t]))
    _same_dict(got, trec.recover_mapping_loop(counts[t], expected[t]))


def test_recovery_takes_shared_and_per_dimm_expectations(campaign):
    _, _, counts, expected = campaign
    for exp in (expected[1, 0, 0], expected[1, :, 0]):   # (R,) and (D, R)
        _same_dict(trec.recover_mapping_population(counts[1], exp,
                                                   device="cpu"),
                   rrec.recover_mapping_population(counts[1], exp))
    with pytest.raises(ValueError, match="integer"):
        trec.recover_mapping_population(expected[1], expected[1],
                                        device="cpu")


def test_vote_and_tables_identical(campaign):
    _, _, counts, expected = campaign
    rec = rrec.recover_mapping_population(counts[2], expected[2])
    nbits = rec["ext_bit"].shape[2]
    args = (rec["ext_bit"].reshape(-1, nbits), rec["xor"].reshape(-1, nbits),
            rec["confidence"].reshape(-1, nbits), rec["order_int"][0, 0])
    got, want = trec.vote_mapping(*args), rrec.vote_mapping(*args)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    R = counts.shape[3]
    for g, w in zip(trec.mapping_tables(*got, R), rrec.mapping_tables(*want, R)):
        np.testing.assert_array_equal(g, w)


def test_generations_identical(campaign):
    _, _, counts, expected = campaign
    feats = rsig.signature_features(rsig.bit_signature_population(counts[1]))
    labels = tgen.cluster_generations(feats)
    np.testing.assert_array_equal(labels, rgen.cluster_generations(feats))
    est = rrec.recover_mapping_population(counts[1],
                                          expected[1])["est_ext_to_int"]
    canon = tgen.canonical_internal_profiles(counts[1], est, labels)
    np.testing.assert_array_equal(
        canon, rgen.canonical_internal_profiles(counts[1], est, labels))
    for p in canon:
        np.testing.assert_array_equal(tgen.vulnerable_rows(p),
                                      rgen.vulnerable_rows(p))
    got, want = tgen.StreamingGenerations(), rgen.StreamingGenerations()
    for lo, hi in ((0, 4), (4, N_DIMMS)):
        np.testing.assert_array_equal(
            got.update(feats[lo:hi], counts[1][lo:hi], est[lo:hi]),
            want.update(feats[lo:hi], counts[1][lo:hi], est[lo:hi]))
    g, w = got.finalize(), want.finalize()
    assert g["n_generations"] == w["n_generations"]
    for k in ("members", "n_profiles", "canonical"):
        np.testing.assert_array_equal(g[k], w[k])
    for a, b in zip(g["vulnerable_rows"], w["vulnerable_rows"]):
        np.testing.assert_array_equal(a, b)


def test_blind_discovery_identical(discoveries):
    want, got = discoveries
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    for k in ("onset", "gen_onset"):
        np.testing.assert_array_equal(got.recovery[k], want.recovery[k])
    for g, w in zip(got.recovery["per_point"], want.recovery["per_point"]):
        _same_dict(g, w)
    s = int(want.serials[2])
    np.testing.assert_array_equal(got.ext_rows_for(s), want.ext_rows_for(s))


@pytest.mark.parametrize("kw", [dict(generation_vote=False), dict(k_rows=4)])
def test_blind_discovery_options_identical(campaign, kw):
    _, _, counts, expected = campaign
    want = rblind.BlindDiva(**kw).discover(counts, expected)
    got = tblind.BlindDiva(**kw).discover(counts, expected, device="cpu")
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))


@pytest.mark.parametrize("multibit", [True, False])
def test_blind_vs_oracle_identical(campaign, discoveries, multibit):
    ref, port, _, _ = campaign
    want_disc, got_disc = discoveries
    want = rblind.blind_vs_oracle(ref, want_disc, multibit_only=multibit)
    got = tblind.blind_vs_oracle(port, got_disc, multibit_only=multibit)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_port_campaign_expectations_and_draws(campaign, monkeypatch):
    ref, port, counts, expected = campaign
    pop = make_population(tgeom.SMALL, N_DIMMS)
    got_counts, got_exp = tblind.campaign_counts(pop, port)
    assert got_counts.shape == counts.shape and got_counts.dtype == np.int64
    np.testing.assert_allclose(got_exp, expected, rtol=LAMBDA_RTOL)
    # fed the reference's lambdas, the port's draws are the reference's
    lams = iter(rsub.row_error_lambda(ref, "trp", t, refresh_ms=256.0,
                                      internal_order=True)
                for t in (10.0, 7.5, 5.0))
    monkeypatch.setattr(tblind, "row_error_lambda",
                        lambda *a, **k: next(lams))
    same_counts, same_exp = tblind.campaign_counts(pop, port)
    np.testing.assert_array_equal(same_counts, counts)
    np.testing.assert_array_equal(same_exp, expected)


def test_port_campaign_discovers_what_the_reference_discovers(campaign,
                                                              discoveries):
    """On its own draws the port's pipeline reaches the reference's
    decisions (on this population)."""
    _, port, _, _ = campaign
    want, _ = discoveries
    c, e = tblind.campaign_counts(make_population(tgeom.SMALL, N_DIMMS), port)
    got = tblind.BlindDiva().discover(c, e, serials=want.serials,
                                      device="cpu")
    for f in ("labels", "ext_rows", "ext_to_int", "vuln_rows"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))

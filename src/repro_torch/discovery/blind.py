"""BlindDiva: geometry-free DIVA Profiling, end to end.

The deployment question of the paper (Sec 5.3 + 6.1): DIVA needs the
design-induced slowest rows, but a real DIMM hides its internal row order
behind vendor scrambling and ships no floorplan.  ``BlindDiva`` goes from
raw observed error counts to a deployable timing table without geometry
metadata:

    observed counts  ->  recover_mapping_population   (scramble recovery)
                     ->  cluster_generations          (design generations)
                     ->  canonical profiles + voting  (cross-DIMM consensus)
                     ->  discovered external test rows per DIMM
                     ->  profile_population(region=)  (restricted DIVA sweep)

The only geometry the pipeline touches is what hardware itself exposes: the
row count and subarray count implied by the address range.  When the final
restricted sweep runs against the *simulated* population, the simulator
decodes the chosen external addresses with the true scramble — exactly what
a memory controller activating those addresses gets for free.

Because the profiling hash never keys on the test region, a DIMM whose
discovered rows name the true design-worst internal rows reproduces the
geometry-oracle ``diva_profile`` table *bit for bit* — the agreement metric
``blind_vs_oracle`` measures.

A copy of ``repro.discovery.blind``: the device passes (row lambdas,
signatures, recovery, the restricted sweeps) run on the batch's or the
given device; clustering, voting and the Poisson draws stay host numpy.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.latency import worst_rows_internal
from repro_torch.core.substrate import (DimmBatch, profile_population_arrays,
                                        row_error_lambda)
from repro_torch.discovery.generation import (canonical_internal_profiles,
                                              cluster_generations,
                                              vulnerable_rows)
from repro_torch.discovery.recover import (mapping_tables,
                                           recover_mapping_population,
                                           vote_mapping)
from repro_torch.discovery.signatures import (bit_signature_population,
                                              signature_features)
from repro_torch.sharding import mesh_device


# ------------------------------------------------------------ the artifact

@dataclass
class BlindDiscovery:
    """Everything one discovery campaign learned about a population."""
    serials: np.ndarray        # (D,) the DIMMs, in campaign order
    labels: np.ndarray         # (D,) generation labels
    ext_rows: np.ndarray       # (D, K) discovered EXTERNAL test rows
    ext_to_int: np.ndarray     # (D, R) voted recovered mappings
    confidence: np.ndarray     # (D, nbits) voted-mapping mean confidences
    canonical: np.ndarray      # (G, R) canonical internal profiles
    vuln_rows: np.ndarray      # (G, K) discovered internal vulnerable rows
    recovery: dict = field(repr=False, default_factory=dict)

    def ext_rows_for(self, serial: int) -> np.ndarray:
        """The discovered external test rows of one DIMM (what
        ``DivaProfiler(discovery=...)`` consumes)."""
        hit = np.flatnonzero(self.serials == serial)
        if hit.size != 1:
            raise KeyError(f"serial {serial} not in this discovery "
                           f"({hit.size} matches)")
        return self.ext_rows[int(hit[0])]


# ------------------------------------------------------------- the pipeline

@dataclass
class BlindDiva:
    """Blind-discovery configuration.  ``k_rows`` sizes the discovered test
    region (DIVA's is 2: both mat-edge rows); ``generation_vote`` pools every
    generation member's recovery into the consensus mapping (the cross-DIMM
    consistency lever) — off, each DIMM votes only across its own
    subarrays; ``onset_min_count`` is the per-subarray max-count level a
    campaign point must reach to count as a DIMM's onset (enough errors to
    make profiles discriminative, not just detectable)."""
    k_rows: int = 2
    cluster_threshold: float = 0.85
    generation_vote: bool = True
    onset_min_count: float = 1024.0

    def discover(self, counts, expected, serials=None, *,
                 device=None, mesh=None) -> BlindDiscovery:
        """Run the discovery pipeline on observed error counts.

        ``counts``: (D, S, R) integer per-external-row counts, or
        (T, D, S, R) — a multi-point campaign (``campaign_counts``), ordered
        mild -> harsh.  Scramble recovery runs per point (every informative
        recovery votes), clustering uses each DIMM's onset-point signature,
        and the vulnerable region is read off each generation's onset-point
        canonical profile — the rows that fail first are the design-worst
        ones.  ``expected``: model-expected internal profiles, same leading
        shape options (or broadcastable).  ``serials``: (D,) DIMM identities
        (default 0..D-1).  The device passes (signatures and recovery) run
        on ``device`` (default: the CUDA device), or split over ``mesh``'s
        devices by DIMM.
        """
        counts = np.asarray(counts)
        if counts.ndim == 2:
            counts = counts[:, None, :]
        counts_t = counts if counts.ndim == 4 else counts[None]
        expected = np.asarray(expected, np.float64)
        expected_t = expected if expected.ndim == 4 \
            else np.broadcast_to(expected, (len(counts_t),) + expected.shape)
        T, D, S, R = counts_t.shape
        serials = np.arange(D) if serials is None else np.asarray(serials)

        # per-DIMM ONSET point: the mildest campaign point with strong
        # signal (median over the DIMM's subarrays of the per-subarray max
        # count — a profile's max survives any row permutation, so no
        # mapping is needed).  The onset is where the profile is
        # discriminative: milder points only graze the extreme tail,
        # harsher points saturate whole arms flat.
        max_t = np.stack([np.median(counts_t[t].max(axis=2), axis=1)
                          for t in range(T)])               # (T, D)
        onset = np.full(D, T - 1, np.int64)
        for d in range(D):
            hits = np.flatnonzero(max_t[:, d] >= self.onset_min_count)
            if hits.size:
                onset[d] = int(hits[0])

        # generations cluster on each DIMM's ONSET-point signature (placed
        # in a per-point feature block: DIMMs with different onsets are
        # different designs by construction and must never merge).  Summed
        # or harsh-point signatures would not do: past saturation the
        # profile collapses toward the shared inverted-U shape and distinct
        # same-vendor dies become cosine-similar.
        sigs_t = np.stack([bit_signature_population(counts_t[t], device=device,
                                                    mesh=mesh)
                           for t in range(T)])              # (T, D, S, nb)
        nbits = sigs_t.shape[3]
        feats = np.zeros((D, T * nbits))
        for d in range(D):
            t = onset[d]
            feats[d, t * nbits:(t + 1) * nbits] = \
                signature_features(sigs_t[t][d][None])[0]
        labels = cluster_generations(feats, self.cluster_threshold)

        # scramble recovery runs per campaign point — every point with
        # signal contributes votes (recovery matches observed against
        # expected AT THE SAME point, so even a saturated point's
        # inverted-U profile identifies bits; what ruins recovery is mixing
        # points first)
        rec_t = [recover_mapping_population(counts_t[t], expected_t[t],
                                            device=device, mesh=mesh)
                 for t in range(T)]
        # a (point, DIMM, subarray) recovery with no observed errors carries
        # no information — its deterministic tie-order junk must not vote
        has_signal = counts_t.max(axis=3) > 0               # (T, D, S)

        # one voted mapping per DIMM, pooling every informative (point,
        # member, subarray) recovery: its own subarrays, or (default) the
        # whole generation's
        est = np.zeros((D, R), np.int64)
        i2e = np.zeros((D, R), np.int64)
        conf = np.zeros((D, nbits))
        for d in range(D):
            voters = np.flatnonzero(labels == labels[d]) \
                if self.generation_vote else np.array([d])
            vb, vx, vc = [], [], []
            for t in range(T):
                keep = has_signal[t][voters].reshape(-1)
                if not keep.any():
                    continue
                vb.append(rec_t[t]["ext_bit"][voters].reshape(-1, nbits)[keep])
                vx.append(rec_t[t]["xor"][voters].reshape(-1, nbits)[keep])
                vc.append(rec_t[t]["confidence"][voters]
                          .reshape(-1, nbits)[keep])
            if not vb:                      # nothing observed anywhere
                vb = [rec_t[-1]["ext_bit"][d]]
                vx = [rec_t[-1]["xor"][d]]
                vc = [rec_t[-1]["confidence"][d]]
            vb, vx, vc = (np.concatenate(v) for v in (vb, vx, vc))
            b, x = vote_mapping(vb, vx, vc,
                                rec_t[onset[d]]["order_int"][d, 0])
            est[d], i2e[d] = mapping_tables(b, x, R)
            # report each bit's mean vote confidence at the consensus pick
            picked = vb == b[None, :]
            denom = np.maximum(picked.sum(axis=0), 1)
            conf[d] = np.where(picked.any(axis=0),
                               (vc * picked).sum(axis=0) / denom, 0.0)

        # canonical per-generation profiles through the VOTED mappings (one
        # per campaign point), and the discovered vulnerable (internal) rows
        # per generation, read off each generation's onset point
        est_s = np.repeat(est[:, None, :], S, axis=1)
        canon_t = np.stack([canonical_internal_profiles(c, est_s, labels)
                            for c in counts_t])            # (T, G, R)
        canonical = canon_t.sum(axis=0)
        G = canonical.shape[0]
        gen_onset = np.zeros(G, np.int64)
        for g in range(G):
            members = np.flatnonzero(labels == g)
            gen_onset[g] = onset[members[0]] if members.size else T - 1
        vuln = np.stack([
            vulnerable_rows(canon_t[gen_onset[g], g], self.k_rows)
            for g in range(G)]) if G else np.zeros((0, 0), int)

        # external addresses each DIMM must test: its generation's vulnerable
        # internal rows pushed through its own recovered inverse mapping
        ext_rows = np.stack([i2e[d, vuln[labels[d]]] for d in range(D)])
        return BlindDiscovery(serials=serials, labels=labels,
                              ext_rows=ext_rows, ext_to_int=est,
                              confidence=conf, canonical=canonical,
                              vuln_rows=vuln,
                              recovery={"per_point": rec_t, "onset": onset,
                                        "gen_onset": gen_onset})

    def profile(self, batch: DimmBatch, disc: BlindDiscovery, *,
                mesh=None, **kw) -> np.ndarray:
        """The restricted DIVA sweep at the discovered addresses: (D, 4)
        profiled timings.  The *simulated* DIMM decodes the external
        addresses with its true scramble (``batch.ext_to_int``) — the address
        decode hardware performs on every activate; the pipeline's own
        estimate never leaks in.  Runs on the batch's device, or split over
        ``mesh``."""
        internal = np.take_along_axis(
            batch.ext_to_int.cpu().numpy().astype(np.int64), disc.ext_rows,
            axis=1)
        return profile_population_arrays(batch, region=internal, mesh=mesh,
                                         **kw)


# ------------------------------------------------------- campaign + metrics

def campaign_counts(pop, batch: DimmBatch | None = None, *,
                    param: str = "trp", t_ops=(10.0, 7.5, 5.0),
                    temp_C: float = 85.0, refresh_ms: float = 256.0,
                    device=None, mesh=None):
    """The discovery error campaign: observed integer error counts (one
    batched lambda pass per operating point + the per-DIMM deterministic
    Poisson draws — the repo's default noise level) and the matching
    model-expected internal profiles (per subarray: subarray position is
    design knowledge).

    ``t_ops`` sweeps several reduced-timing points, the paper's Sec 4
    methodology (Fig 6 sweeps {12.5, 10, 7.5, 5} ns) turned into a single
    campaign, ordered mild -> harsh: a die that saturates at the harsh
    points is read off its onset point, while a low-variation die that
    never fails at the mild points gets its signal from the harsh one
    (where the weak-cell outlier fold carries the design shape).  One
    ``row_error_lambda`` per point on the batch's device (``batch``, else a
    batch of ``pop`` on ``device``, default the CUDA device) for the
    expensive grids; sampling stays on the per-DIMM numpy stream so each
    point's counts match ``DimmModel.row_error_counts``.  ``mesh`` shards
    the lambda passes over the DIMM axis (the batch of ``pop`` then lands on
    its first device).

    Returns ``(counts, expected)`` stacked over the campaign points:
    (T, D, S, R) integer counts and (T, D, S, R) float expectations, in the
    given point order — what ``BlindDiva.discover`` consumes directly; sum
    over the T axis for a single-profile view."""
    if batch is None:
        batch = DimmBatch.from_population(pop, mesh_device(mesh, device))
    g = batch.geom
    D, S, R = len(pop), g.subarrays, g.rows_per_mat
    # the external-order view is the internal one gathered through each
    # DIMM's scramble (the exact op row_error_lambda applies on the device),
    # so ONE device pass per point serves both the sampling lambda and the
    # expected profile — bit-identical to two passes at half the cost
    e2i = np.repeat(batch.ext_to_int.cpu().numpy().astype(np.int64)[:, None, :],
                    S, axis=1)
    counts, expected = [], []
    for t_op in np.atleast_1d(np.asarray(t_ops, np.float64)):
        t_op = float(t_op)
        lam_int = row_error_lambda(batch, param, t_op, temp_C=temp_C,
                                   refresh_ms=refresh_ms, internal_order=True,
                                   mesh=mesh).reshape(D, S, R)
        lam_ext = np.take_along_axis(lam_int, e2i, axis=2)
        counts.append(np.stack([
            d.sample_row_counts(lam_ext[i].reshape(-1), param, t_op,
                                temp_C=temp_C, refresh_ms=refresh_ms)
            for i, d in enumerate(pop)
        ]).reshape(D, S, R).astype(np.int64))
        expected.append(lam_int.astype(np.float64))
    return np.stack(counts), np.stack(expected)


def blind_vs_oracle(batch: DimmBatch, disc: BlindDiscovery, *, mesh=None,
                    **kw) -> dict:
    """Blind vs geometry-oracle DIVA on one population: per-DIMM timing
    agreement (exact (4,)-row equality — the hash never keys on the region,
    so a correctly discovered region reproduces the oracle bit for bit) and
    the test cost each mode pays per profiling pass.  Runs on the batch's
    device, or split over ``mesh``."""
    diva = BlindDiva(k_rows=disc.ext_rows.shape[1])
    blind = diva.profile(batch, disc, mesh=mesh, **kw)
    oracle = profile_population_arrays(batch, region="worst", mesh=mesh, **kw)
    row_agree = np.all(blind == oracle, axis=1)
    g = batch.geom
    worst = worst_rows_internal(g)
    e2i = batch.ext_to_int.cpu().numpy()
    region_hit = np.array([
        set(np.take(e2i[d], disc.ext_rows[d])) == set(worst)
        for d in range(batch.n_dimms)])
    rows_total = g.rows_per_mat * g.subarrays
    return {"agreement": float(row_agree.mean()),
            "n_agree": int(row_agree.sum()),
            "n_dimms": batch.n_dimms,
            "region_recovered_frac": float(region_hit.mean()),
            "blind": blind, "oracle": oracle,
            # per-pass test cost in rows: both DIVA modes test k rows per
            # subarray-equivalent region; conventional tests everything.
            "rows_tested_blind": int(disc.ext_rows.shape[1]),
            "rows_tested_oracle": int(len(worst)),
            "rows_tested_conventional": int(rows_total)}

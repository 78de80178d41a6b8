"""``FleetServer``: the paper's online DIVA Profiling as a fleet service
(the counterpart of ``repro.serve.server``).

DIMMs arrive as streaming telemetry chunks (``core/streaming``), get a
timing table by the cheapest path their signature allows, and stay fresh
through a staleness-driven re-profiling queue.  Each chunk runs eagerly on
the stream's device: the campaign's row lambdas and the discovery lambdas
through the ``fail_prob_rows`` kernel, signatures and scramble recovery through
``bit_signature``, the profiling sweeps as plain torch ops, and checkpoints
through the codec's ``secded_encode`` / ``diva_shuffle`` /
``secded_syndrome``.

Serving paths, cheapest first:

  * HIT — the DIMM's campaign signature cosine-matches a cached generation
    (``serve.state.GenerationCache``): its table comes from a K-row sweep at
    the generation's cached external test addresses.  Because the profiling
    hash never keys on the test region, a hit whose cached addresses decode
    to the design-worst internal rows reproduces the geometry-oracle
    ``diva_profile`` table bit for bit — the bench's parity gate.
  * DISCOVER — the signature founds a new generation: scramble recovery is
    pooled over the founding members (votes from every informative (point,
    member, subarray) recovery), the vulnerable rows are read off the
    generation's onset-point canonical profile, and the resulting external
    addresses are cached so every LATER member of the generation hits.
  * CONVENTIONAL — no usable signature (zero errors at every campaign
    point), or a signature matching an UNVERIFIED generation (one whose
    founding vote pool was too small or too incoherent to trust the
    discovered region): the safe every-row sweep.

Staleness: a table profiled with ``guard_cycles`` cycles of margin stays
safe until aging drift (``aging_coef`` ns/year — the lifetime model's
adder) consumes the guard band, so each DIMM's re-profile deadline is
``profiled_at + guard / aging_coef`` (clamped).  ``tick(now)`` drains the
deadline heap and re-profiles due DIMMs in chunked sweeps at their cached
regions under the aged operating condition.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.latency import DEFAULT_ITERS, DEFAULT_PATTERNS
from repro_torch.core.streaming import as_stream, hash_poisson_counts
from repro_torch.core.substrate import (_LEAVES, _profile_impl,
                                        lifetime_adders, pattern_stress,
                                        profile_population_arrays,
                                        row_error_lambda)
from repro_torch.core.timing import CYCLE_NS, PARAMS
from repro_torch.device import resolve_device
from repro_torch.discovery.generation import vulnerable_rows
from repro_torch.discovery.recover import (mapping_tables,
                                           recover_mapping_population,
                                           vote_mapping)
from repro_torch.discovery.signatures import (bit_signature_population,
                                              signature_features)
from repro_torch.obs import REGISTRY as _OBS_REGISTRY
from repro_torch.obs import span as _span
from repro_torch.serve.state import (PATH_CONVENTIONAL, PATH_DISCOVER,
                                     PATH_HIT, FleetState, GenerationCache)

# Serving-layer metrics (obs layer, ARCHITECTURE 3h).  Every series is
# labeled with a process-unique server id so several FleetServers in one
# process (tests, checkpoint roundtrips) never mix counts; each server holds
# its bound children — no label resolution on the serving path.
_SERVER_IDS = itertools.count()
_PATH_NAMES = {PATH_HIT: "hit", PATH_DISCOVER: "discover",
               PATH_CONVENTIONAL: "conventional"}
_M_INGEST = _OBS_REGISTRY.counter(
    "repro_serve_ingest_total", "DIMMs ingested by serving path",
    labelnames=("server", "path"))
_M_QUERIES = _OBS_REGISTRY.counter(
    "repro_serve_queries_total", "timing-table queries served",
    labelnames=("server",))
_M_QLAT = _OBS_REGISTRY.histogram(
    "repro_serve_query_latency_seconds", "table query latency",
    labelnames=("server",))
_M_AGE = _OBS_REGISTRY.gauge(
    "repro_serve_max_table_age_years",
    "worst served-table age at the last staleness() call",
    labelnames=("server",))
_M_GENS = _OBS_REGISTRY.gauge(
    "repro_serve_generations", "generations in the signature cache",
    labelnames=("server",))
_M_REPROF = _OBS_REGISTRY.counter(
    "repro_serve_reprofiled_total", "DIMMs re-profiled by tick()",
    labelnames=("server",))


# DIMMs a conventional every-row sweep takes at once: its eager
# temporaries grow with DIMMs x rows (~64 MB a DIMM each at FULL geometry),
# and per-DIMM tables do not depend on the grouping
_CONVENTIONAL_PIECE = 16


def take_batch(batch, idx):
    """Arbitrary-index population subset (the fancy-index sibling of
    ``streaming.slice_batch``), on the batch's device."""
    idx = torch.as_tensor(np.asarray(idx, np.int64), device=batch.device)
    return dataclasses.replace(
        batch, **{n: getattr(batch, n)[idx] for n in _LEAVES})


def concat_batches(parts):
    if len(parts) == 1:
        return parts[0]
    return dataclasses.replace(
        parts[0], **{n: torch.cat([getattr(p, n) for p in parts])
                     for n in _LEAVES})


@dataclass(frozen=True)
class FleetConfig:
    """Operating points and policies of one fleet server."""
    chunk_size: int = 512
    # generation matching: campaign telemetry -> onset-block signatures
    threshold: float = 0.85
    k_rows: int = 2
    campaign_param: str = "trp"
    campaign_t_ops: tuple = (10.0, 7.5, 5.0)
    campaign_temp_C: float = 85.0
    campaign_refresh_ms: float = 256.0
    campaign_seed: int = 0
    onset_min_count: float = 1024.0
    # generation verification: a discovered region is trusted for future
    # hits only when the founding vote pool was large enough and agreed
    # strongly enough on one scramble (see _discover)
    consensus_min_share: float = 0.55
    min_founders: int = 4
    # the served operating point (diva_profile defaults)
    profile_temp_C: float = 55.0
    profile_refresh_ms: float = 64.0
    guard_cycles: int = 1
    multibit_only: bool = True
    # staleness: horizon_years = clamp(safety * guard_ns / aging_coef)
    stale_safety: float = 1.0
    horizon_min_years: float = 0.25
    horizon_max_years: float = 10.0


class FleetServer:
    """Online timing-table service over one ``PopulationStream``, on the
    stream's device (a stream that states none: the CUDA device).

    ``ingest`` registers the next DIMMs of the stream (chunks in serial
    order — the clusterer's contract), ``query``/``query_batch`` serve
    tables, ``tick`` re-profiles due DIMMs, ``save``/``load`` checkpoint the
    whole serving state (generation cache included) so a restarted server
    resumes mid-ingest with identical labels, tables, and deadlines.

    ``counts_fn`` supplies the campaign counts, with
    ``hash_poisson_counts``' signature (the default): parity runs pass the
    reference's counts through it, since the port's sampler draws other
    bits.
    """

    def __init__(self, source, config: FleetConfig = FleetConfig(), *,
                 checkpoint_dir: str | None = None, keep: int = 3,
                 counts_fn=None):
        self.stream = as_stream(source)
        self.device = resolve_device(self.stream.device)
        self.cfg = config
        self._counts_fn = hash_poisson_counts if counts_fn is None \
            else counts_fn
        self.cache = GenerationCache(threshold=config.threshold)
        self.state = FleetState()
        self._heap: list[tuple[float, int]] = []
        self._ingested = 0          # stream serials [0, _ingested) are live
        self.clock = 0.0            # fleet age (years) of the last ingest/tick
        self.ckpt = None
        if checkpoint_dir is not None:
            from repro_torch.checkpoint.manager import CheckpointManager
            self.ckpt = CheckpointManager(checkpoint_dir, keep=keep)
        g = self.stream.geom
        self.founding_stats: dict[int, dict] = {}
        self._full = int(config.chunk_size)
        self._stress = torch.as_tensor(pattern_stress(DEFAULT_PATTERNS),
                                       device=self.device)
        self._statics = dict(guard_cycles=config.guard_cycles,
                             iters=DEFAULT_ITERS,
                             multibit=config.multibit_only, banks=1,
                             axes=PARAMS, retention=False)
        self._nbits = int(np.log2(g.rows_per_mat))
        self._sid = str(next(_SERVER_IDS))
        self._m_path = {name: _M_INGEST.labels(server=self._sid, path=name)
                        for name in _PATH_NAMES.values()}
        self._m_queries = _M_QUERIES.labels(server=self._sid)
        self._m_qlat = _M_QLAT.labels(server=self._sid)
        self._m_age = _M_AGE.labels(server=self._sid)
        self._m_gens = _M_GENS.labels(server=self._sid)
        self._m_reprof = _M_REPROF.labels(server=self._sid)

    # ------------------------------------------------------------- ingest

    def ingest(self, n: int | None = None, *, now: float | None = None
               ) -> dict:
        """Register the next ``n`` DIMMs of the stream (default: the rest).
        Returns per-path counts for the ingested span."""
        now = self.clock if now is None else float(now)
        lo0 = self._ingested
        hi0 = self.stream.n_dimms if n is None else min(lo0 + int(n),
                                                        self.stream.n_dimms)
        before = (self.cache.hits, self.cache.misses, self.cache.conventional)
        for lo in range(lo0, hi0, self._full):
            hi = min(lo + self._full, hi0)
            with _span("serve.ingest_chunk", server=self._sid, lo=lo, hi=hi):
                self._ingest_chunk(self.stream.chunk(lo, hi), now)
            self._ingested = hi
        self.clock = max(self.clock, now)
        return {"ingested": hi0 - lo0,
                "hits": self.cache.hits - before[0],
                "misses": self.cache.misses - before[1],
                "conventional": self.cache.conventional - before[2],
                "n_generations": self.cache.n_generations}

    def _ingest_chunk(self, batch, now: float) -> None:
        cfg = self.cfg
        n = batch.n_dimms
        g = batch.geom

        # campaign telemetry: serial-keyed counts at every operating point
        counts_t = np.stack([
            np.asarray(self._counts_fn(
                batch, cfg.campaign_param, float(t),
                temp_C=cfg.campaign_temp_C,
                refresh_ms=cfg.campaign_refresh_ms, seed=cfg.campaign_seed),
                np.int64).reshape(n, g.subarrays, g.rows_per_mat)
            for t in cfg.campaign_t_ops])                  # (T, n, S, R)
        T = counts_t.shape[0]

        # per-DIMM onset point + onset-block signature features (the
        # BlindDiva matching key: DIMMs with different onsets are different
        # designs and land in disjoint feature blocks)
        max_t = np.stack([np.median(counts_t[t].max(axis=2), axis=1)
                          for t in range(T)])              # (T, n)
        onset = np.full(n, T - 1, np.int64)
        for d in range(n):
            hit = np.flatnonzero(max_t[:, d] >= cfg.onset_min_count)
            if hit.size:
                onset[d] = int(hit[0])
        feats_t = [signature_features(
            bit_signature_population(counts_t[t].astype(np.int32),
                                     device=self.device))
            for t in range(T)]                             # T x (n, nbits)
        nb = self._nbits
        feats = np.zeros((n, T * nb))
        for d in range(n):
            t = onset[d]
            feats[d, t * nb:(t + 1) * nb] = feats_t[t][d]

        labels = self.cache.match(feats)                   # (n,) provisional

        # paths: hit = label with a VERIFIED cached region; new labels found
        # generations (verification happens at founding — see _discover).
        # Members of an unverified generation keep the label for cluster
        # accounting but take the safe conventional sweep.
        genuine = max_t[onset, np.arange(n)] >= cfg.onset_min_count
        new_gens = sorted({int(l) for l in labels
                           if l >= 0 and not self.cache.known(l)})
        if new_gens:
            with _span("serve.discover", server=self._sid,
                       n_generations=len(new_gens)):
                self._discover(batch, counts_t, onset, labels, new_gens,
                               genuine)
        ver = np.asarray([l >= 0 and self.cache.verified(int(l))
                          for l in labels])
        path = np.where(~ver, PATH_CONVENTIONAL,
                        np.where(np.isin(labels, new_gens),
                                 PATH_DISCOVER, PATH_HIT)).astype(np.int8)
        conv = path == PATH_CONVENTIONAL
        self.cache.hits += int((path == PATH_HIT).sum())
        self.cache.misses += int((path == PATH_DISCOVER).sum())
        self.cache.conventional += int(conv.sum())
        for code, name in _PATH_NAMES.items():
            self._m_path[name].inc(int((path == code).sum()))
        self._m_gens.set(self.cache.n_generations)

        # one restricted sweep for every DIMM with a verified region (hit +
        # fresh discoveries); conventional DIMMs take the every-row sweep
        e2i = batch.ext_to_int.cpu().numpy().astype(np.int64)
        internal = np.zeros((n, cfg.k_rows), np.int64)
        for d in range(n):
            if not conv[d]:
                internal[d] = e2i[d][self.cache.ext_rows(labels[d])]
        tables = self._profile_rows(batch, internal, now)
        if conv.any():
            sub = take_batch(batch, np.flatnonzero(conv))
            tables[conv] = self._profile_all_rows(sub, now)

        horizon = self._horizon_years(batch)
        due = now + horizon
        serials = batch.serial.cpu().numpy().astype(np.int64)
        self.state.append(serials, tables, labels, path,
                          np.full(n, now, np.float32), due, horizon)
        for s, t in zip(serials, due):
            heapq.heappush(self._heap, (float(t), int(s)))

    # ----------------------------------------------------- discovery (miss)

    def _discover(self, batch, counts_t, onset, labels, new_gens,
                  genuine) -> None:
        """Found new generations from this chunk's unmatched members: pooled
        scramble recovery -> onset canonical profile -> vulnerable rows ->
        cached external test addresses.  A generation is cached VERIFIED
        only when the founding pool is big enough (``min_founders``) and its
        votes agree strongly enough on one scramble
        (``consensus_min_share``) — otherwise the label survives for
        cluster accounting but members take the conventional sweep."""
        cfg = self.cfg
        g = batch.geom
        S, R = g.subarrays, g.rows_per_mat
        idx = np.flatnonzero(np.isin(labels, new_gens))
        m = len(idx)
        sub = take_batch(batch, idx)
        sub_counts = counts_t[:, idx]                      # (T, m, S, R)
        T = sub_counts.shape[0]

        # per-point recovery on the founding members: the expected lambdas
        # (one fail_prob_rows launch per (subarray, pattern)), then every
        # (member, subarray) scramble in one recovery call
        rec_t = []
        for t, t_op in enumerate(cfg.campaign_t_ops):
            lam = row_error_lambda(
                sub, cfg.campaign_param, float(t_op),
                temp_C=cfg.campaign_temp_C,
                refresh_ms=cfg.campaign_refresh_ms,
                internal_order=True).reshape(m, S, R)
            rec_t.append(recover_mapping_population(
                sub_counts[t].astype(np.int64), lam, device=self.device))
        has_signal = sub_counts.max(axis=3) > 0            # (T, m, S)

        nb = self._nbits
        for gen in new_gens:
            pos = np.flatnonzero(labels[idx] == gen)       # positions in sub
            vb, vx, vc = [], [], []
            for t in range(T):
                keep = has_signal[t][pos].reshape(-1)
                if not keep.any():
                    continue
                vb.append(rec_t[t]["ext_bit"][pos].reshape(-1, nb)[keep])
                vx.append(rec_t[t]["xor"][pos].reshape(-1, nb)[keep])
                vc.append(rec_t[t]["confidence"][pos].reshape(-1, nb)[keep])
            if not vb:                                     # nothing observed
                vb = [rec_t[-1]["ext_bit"][pos[0]]]
                vx = [rec_t[-1]["xor"][pos[0]]]
                vc = [rec_t[-1]["confidence"][pos[0]]]
            vb, vx, vc = (np.concatenate(v) for v in (vb, vx, vc))
            founder = int(pos[0])
            t_on = int(onset[idx[founder]])
            b, x = vote_mapping(vb, vx, vc,
                                rec_t[t_on]["order_int"][founder, 0])
            est, i2e = mapping_tables(b, x, R)             # consensus map
            # generation canonical profile at the onset point, scattered
            # back through the consensus mapping
            summed = sub_counts[t_on, pos].sum(axis=(0, 1))  # (R,) external
            prof = np.zeros(R, np.int64)
            np.add.at(prof, est, summed)
            vuln = vulnerable_rows(prof, cfg.k_rows)
            mass = float(prof[vuln].sum()) / float(max(prof.sum(), 1))
            # consensus quality: confidence-weighted fraction of the vote
            # pool that agrees with the voted scramble, per internal bit.
            # A real generation's members vote coherently (share >~ 0.6);
            # a cluster of weak-die noise scatters (share <~ 0.5) — and a
            # tiny pool can be wrong while fully self-consistent, so small
            # foundings are never trusted regardless of share.
            agree = (vb == b[None, :]) & (vx == x[None, :])  # (K, nbits)
            wsum = np.maximum(vc.sum(axis=0), 1e-9)
            share = (vc * agree).sum(axis=0) / wsum          # per int bit
            verified = (float(share.mean()) >= cfg.consensus_min_share
                        and len(pos) >= cfg.min_founders)
            self.founding_stats[int(gen)] = {
                "n_founders": int(len(pos)), "region_mass": mass,
                "conf_mean": float(vc.mean()),
                "share_mean": float(share.mean()),
                "share_min": float(share.min()),
                "all_genuine": bool(genuine[idx[pos]].all()),
                "verified": verified}
            self.cache.install(gen, i2e[vuln], verified=verified)

    # --------------------------------------------------------- profiling

    def _profile_rows(self, batch, internal_rows, now: float) -> np.ndarray:
        """(C, 4) tables at per-DIMM (C, K) internal regions: one
        ``_profile_impl`` sweep on the batch's device."""
        n = batch.n_dimms
        rows = torch.as_tensor(np.asarray(internal_rows, np.int64),
                               device=batch.device)
        adder = torch.as_tensor(self._adder(batch, now), device=batch.device)
        with _span("serve.profile_rows", server=self._sid, n=n) as sp:
            out = _profile_impl(batch, rows, self._stress, adder,
                                **self._statics)
            sp.bind(out)
        return out.cpu().numpy().astype(np.float32)[:, 0]

    def _profile_all_rows(self, batch, now: float) -> np.ndarray:
        """Conventional every-row sweep for the signatureless fallback, at
        most ``_CONVENTIONAL_PIECE`` DIMMs at a time."""
        cfg = self.cfg
        aged = dataclasses.replace(
            batch, age_years=torch.full((batch.n_dimms,), float(now),
                                        dtype=torch.float32,
                                        device=batch.device))
        n = batch.n_dimms
        with _span("serve.conventional_sweep", server=self._sid, n=n):
            return np.concatenate([np.asarray(profile_population_arrays(
                take_batch(aged, np.arange(lo, min(lo + _CONVENTIONAL_PIECE,
                                                   n))),
                region="all", temp_C=cfg.profile_temp_C,
                refresh_ms=cfg.profile_refresh_ms,
                guard_cycles=cfg.guard_cycles,
                multibit_only=cfg.multibit_only), np.float32)[:, :4]
                for lo in range(0, n, _CONVENTIONAL_PIECE)])

    def _adder(self, batch, now: float) -> np.ndarray:
        """The aged operating-condition adder: ``condition_adders`` with the
        fleet clock overriding the batch's static age (bit-identical op
        order via ``lifetime_adders``)."""
        cfg = self.cfg
        return lifetime_adders(batch, np.full(1, now, np.float32),
                               np.full(1, cfg.profile_temp_C),
                               cfg.profile_refresh_ms)[0]

    def _horizon_years(self, batch) -> np.ndarray:
        cfg = self.cfg
        guard_ns = cfg.stale_safety * cfg.guard_cycles * CYCLE_NS
        ac = np.maximum(batch.aging_coef.cpu().numpy().astype(np.float32),
                        1e-6)
        return np.clip(guard_ns / ac, cfg.horizon_min_years,
                       cfg.horizon_max_years).astype(np.float32)

    # ------------------------------------------------------------ queries

    def query(self, serial: int) -> dict:
        """One DIMM's serving record; KeyError for unknown serials."""
        if int(serial) not in self.state.index:
            raise KeyError(f"serial {int(serial)} not registered")
        with _span("serve.query", self._m_qlat, server=self._sid):
            i = self.state.index[int(serial)]
            out = {"serial": int(serial),
                   "table": self.state.view("table")[i].copy(),
                   "label": int(self.state.view("label")[i]),
                   "path": int(self.state.view("path")[i]),
                   "profiled_at": float(self.state.view("profiled_at")[i]),
                   "due_at": float(self.state.view("due_at")[i])}
        self._m_queries.inc()
        return out

    def query_batch(self, serials) -> np.ndarray:
        """(Q, 4) timing tables for a batch of serials (one gather)."""
        with _span("serve.query_batch", self._m_qlat, server=self._sid):
            rows = self.state.rows_for(serials)
            out = self.state.view("table")[rows]
        self._m_queries.inc(len(rows))
        return out

    def staleness(self, now: float | None = None) -> dict:
        """Fleet staleness report at ``now`` (default: the server clock):
        the worst table age, the fleet's staleness bound (max horizon), and
        how many DIMMs are past their deadline."""
        now = self.clock if now is None else float(now)
        age = now - self.state.view("profiled_at")
        horizon = self.state.view("horizon")
        out = {"now": now,
               "max_staleness_years": float(age.max()) if len(age) else 0.0,
               "bound_years": float(horizon.max()) if len(horizon) else 0.0,
               "n_overdue": int((self.state.view("due_at") < now).sum())}
        self._m_age.set(out["max_staleness_years"])
        return out

    def metrics(self) -> dict:
        """This server's observability block, read off the obs registry:
        serving-path mix, query count + latency histogram summary, the
        staleness gauge (refreshed here) and generation-cache hit rate.  The
        reference's ``chunk_compiles`` (its chunk-cache compile counts) is
        left out: the port compiles no chunk programs."""
        self.staleness()                       # refresh the age gauge
        paths = {name: int(c.value()) for name, c in self._m_path.items()}
        matched = paths["hit"] + paths["discover"]
        total = matched + paths["conventional"]
        return {"server": self._sid,
                "paths": paths,
                "ingested": int(self._ingested),
                "hit_rate": paths["hit"] / total if total else 0.0,
                "generations": int(self.cache.n_generations),
                "queries": int(self._m_queries.value()),
                "query_latency_seconds": self._m_qlat.summary(),
                "max_table_age_years": float(self._m_age.value()),
                "reprofiled": int(self._m_reprof.value())}

    # --------------------------------------------------------------- tick

    def tick(self, now: float) -> dict:
        """Advance the fleet clock and re-profile every DIMM whose deadline
        passed, in chunked sweeps at the cached regions under the aged
        condition.  Returns the re-profile count."""
        due: list[int] = []
        while self._heap and self._heap[0][0] <= now:
            _, s = heapq.heappop(self._heap)
            # stale heap entries (superseded by a later re-profile) drop out
            i = self.state.index.get(s)
            if i is not None and self.state.view("due_at")[i] <= now:
                due.append(s)
        with _span("serve.tick", server=self._sid, now=now,
                   reprofiled=len(due)):
            for lo in range(0, len(due), self._full):
                self._reprofile(np.asarray(due[lo:lo + self._full]), now)
        self._m_reprof.inc(len(due))
        self.clock = max(self.clock, now)
        return {"now": now, "reprofiled": len(due)}

    def _reprofile(self, serials: np.ndarray, now: float) -> None:
        cfg = self.cfg
        serials = np.sort(serials)
        runs = np.split(serials, np.flatnonzero(np.diff(serials) != 1) + 1)
        batch = concat_batches([self.stream.chunk(int(r[0]), int(r[-1]) + 1)
                                for r in runs])
        rows_idx = self.state.rows_for(serials)
        labels = self.state.view("label")[rows_idx]
        path = self.state.view("path")[rows_idx]
        conv = path == PATH_CONVENTIONAL
        e2i = batch.ext_to_int.cpu().numpy().astype(np.int64)
        internal = np.zeros((len(serials), cfg.k_rows), np.int64)
        for j in range(len(serials)):
            if not conv[j]:
                internal[j] = e2i[j][self.cache.ext_rows(labels[j])]
        tables = self._profile_rows(batch, internal, now)
        if conv.any():
            sub = take_batch(batch, np.flatnonzero(conv))
            tables[conv] = self._profile_all_rows(sub, now)
        due = now + self.state.view("horizon")[rows_idx]
        self.state.update_rows(rows_idx, tables, now, due)
        for s, t in zip(serials, due):
            heapq.heappush(self._heap, (float(t), int(s)))

    # --------------------------------------------------------- checkpoint

    # the fixed checkpoint key set: the checkpoint flattens in sorted-key
    # order, so these names + the saved meta shapes reconstruct the
    # example_state for a restore that knows nothing else
    _STATE_KEYS = ("cache_counters", "cache_ext_rows", "cache_leaders",
                   "cache_members", "cache_verified", "fleet_due_at",
                   "fleet_horizon", "fleet_label", "fleet_path",
                   "fleet_profiled_at", "fleet_serial", "fleet_table",
                   "server_meta")

    def state_dict(self) -> dict[str, np.ndarray]:
        out = {f"fleet_{k}": v for k, v in self.state.state_dict().items()}
        out.update({f"cache_{k}": v
                    for k, v in self.cache.state_dict().items()})
        out["server_meta"] = np.asarray([self._ingested, self.clock],
                                        np.float64)
        assert tuple(sorted(out)) == self._STATE_KEYS
        return out

    def load_state(self, state: dict[str, np.ndarray]) -> None:
        self.state.load_state(
            {k[len("fleet_"):]: v for k, v in state.items()
             if k.startswith("fleet_")})
        self.cache.load_state(
            {k[len("cache_"):]: v for k, v in state.items()
             if k.startswith("cache_")})
        meta = np.asarray(state["server_meta"], np.float64)
        self._ingested = int(meta[0])
        self.clock = float(meta[1])
        self._heap = [(float(t), int(s))
                      for t, s in zip(self.state.view("due_at"),
                                      self.state.view("serial"))]
        heapq.heapify(self._heap)

    def save(self, step: int):
        if self.ckpt is None:
            raise RuntimeError("FleetServer built without checkpoint_dir")
        return self.ckpt.save(step, self.state_dict(), device=self.device)

    def load(self, step: int | None = None) -> dict:
        """Restore from the checkpoint directory WITHOUT an in-memory
        example: leaf shapes/dtypes come from the saved meta (the fixed
        ``_STATE_KEYS`` set flattens in sorted order, matching the saved
        leaf order by construction)."""
        if self.ckpt is None:
            raise RuntimeError("FleetServer built without checkpoint_dir")
        meta = self.ckpt.meta(step)
        if len(meta["leaves"]) != len(self._STATE_KEYS):
            raise ValueError(
                f"checkpoint has {len(meta['leaves'])} leaves; a fleet "
                f"state has {len(self._STATE_KEYS)}")
        example = {k: np.zeros(info["shape"], np.dtype(info["dtype"]))
                   for k, info in zip(self._STATE_KEYS, meta["leaves"])}
        state, info = self.ckpt.restore(example, step, device=self.device)
        self.load_state(state)
        return info

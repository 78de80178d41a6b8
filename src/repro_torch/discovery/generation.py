"""Generation inference: cluster DIMMs by error-signature similarity.

The paper's deployment story rests on Sec 5.3's observation that the
scramble (and the vulnerable-region layout behind it) is *consistent across
a DRAM generation*: DIMMs of the same design show the same mapping.  This
module turns that into a testable artifact — cluster the population by the
cosine similarity of their address-bit signatures and emit each
generation's canonical internal error profile plus its discovered
vulnerable rows (the per-generation consensus *scramble* is voted in
``blind.BlindDiva.discover``, which pools every informative campaign
point's recovery).

All host-side numpy (D is at most hundreds; the expensive signature pass
already ran on device), deterministic: greedy leader clustering in serial
order, stable tie-breaks everywhere.  A copy of
``repro.discovery.generation``.
"""
from __future__ import annotations

import numpy as np


def cluster_generations(features: np.ndarray, threshold: float = 0.85
                        ) -> np.ndarray:
    """(D,) int labels from (D, F) L2-normalized signature features
    (``signatures.signature_features``).  Greedy leader clustering: walk
    DIMMs in order, join the first cluster whose leader's cosine similarity
    clears ``threshold``, else found a new one.  Zero vectors (the paper's
    "no observed variation" DIMMs — nothing to match on) all land in one
    shared cluster."""
    feats = np.asarray(features, np.float64)
    zero = np.linalg.norm(feats, axis=1) == 0
    labels = np.full(feats.shape[0], -1, np.int64)
    leaders: list[np.ndarray] = []
    for d in range(feats.shape[0]):
        if zero[d]:
            continue
        for g, lead in enumerate(leaders):
            if float(feats[d] @ lead) >= threshold:
                labels[d] = g
                break
        else:
            labels[d] = len(leaders)
            leaders.append(feats[d])
    if zero.any():
        labels[zero] = len(leaders)
    return labels


def canonical_internal_profiles(counts: np.ndarray, est_ext_to_int: np.ndarray,
                                labels: np.ndarray,
                                combine: str = "median") -> np.ndarray:
    """(G, R) canonical per-generation internal error profiles: every member
    subarray's observed external counts scattered back through its recovered
    mapping, combined per row over the generation's member-subarrays.  For a
    correctly recovered generation this re-exposes the design profile the
    scramble hid — the paper's 'same design, same vulnerable regions' made
    concrete.

    ``combine="median"`` (default) is what makes the canonical map robust to
    per-DIMM randomness: a post-manufacturing row repair gives one
    member-subarray a hot replacement-row profile at a random row, which a
    mean would smear into a spurious vulnerable row.  ``combine="mean"`` is
    the online-computable alternative the streaming clusterer
    (``StreamingGenerations``) accumulates as exact integer sums: for
    integer counts the two paths' means agree bit for bit (integer
    arithmetic in f64 is exact below 2**53), which is the streamed
    discovery's parity anchor."""
    if combine not in ("median", "mean"):
        raise ValueError(f"combine must be 'median' or 'mean', "
                         f"got {combine!r}")
    counts = np.asarray(counts, np.float64)
    est = np.asarray(est_ext_to_int)
    labels = np.asarray(labels)
    D, S, R = counts.shape
    G = int(labels.max()) + 1 if labels.size else 0
    fold = np.median if combine == "median" else np.mean
    out = np.zeros((G, R))
    for g in range(G):
        members = np.flatnonzero(labels == g)
        scat = np.zeros((len(members) * S, R))
        for j, d in enumerate(members):
            for s in range(S):
                scat[j * S + s, est[d, s]] = counts[d, s]
        out[g] = fold(scat, axis=0) if scat.size else 0.0
    return out


class StreamingGenerations:
    """Incremental greedy leader clustering over population chunks — the
    streaming form of ``cluster_generations`` + mean-combine
    ``canonical_internal_profiles`` + ``vulnerable_rows``, state bounded by
    the number of GENERATIONS (small), never the number of DIMMs.

    ``update`` consumes one chunk of (C, F) features (chunks must arrive in
    serial order) and returns provisional labels; zero-feature DIMMs carry
    ``-1`` until ``finalize``/``resolve_labels`` assigns the shared
    trailing cluster — its index is the final leader count, which a
    streaming pass cannot know mid-scan (the dense clusterer assigns it at
    the end of its walk for the same reason).  Label parity with the dense
    clusterer holds because leaders are compared in creation order and a
    chunk boundary never reorders the walk.

    Canonical profiles accumulate as EXACT int64 row sums (optionally
    scattered through per-subarray ``est`` maps), so ``finalize``'s mean
    profiles are bit-identical to the dense
    ``canonical_internal_profiles(..., combine="mean")`` at any chunk size.
    """

    def __init__(self, threshold: float = 0.85):
        self.threshold = float(threshold)
        self._leaders: list[np.ndarray] = []
        self._sums: list[np.ndarray] = []       # per-gen (R,) int64
        self._profiles: list[int] = []          # per-gen member-subarray count
        self._members: list[int] = []
        self._zero_sum: np.ndarray | None = None
        self._zero_profiles = 0
        self._zero_members = 0
        self._rows: int | None = None

    @property
    def n_leaders(self) -> int:
        return len(self._leaders)

    def _match(self, feat: np.ndarray) -> int:
        for g, lead in enumerate(self._leaders):
            if float(feat @ lead) >= self.threshold:
                return g
        self._leaders.append(feat)
        self._sums.append(None)
        self._profiles.append(0)
        self._members.append(0)
        return len(self._leaders) - 1

    def update(self, features: np.ndarray, counts: np.ndarray | None = None,
               est_ext_to_int: np.ndarray | None = None) -> np.ndarray:
        """Fold one chunk; returns (C,) provisional labels (-1 = zero
        feature).  ``counts`` (C, S, R) integer campaign counts feed the
        exact canonical sums; ``est_ext_to_int`` (C, S, R) scatters each
        member subarray through its recovered mapping (identity when
        omitted — external-order canonicals)."""
        feats = np.asarray(features, np.float64)
        zero = np.linalg.norm(feats, axis=1) == 0
        labels = np.full(feats.shape[0], -1, np.int64)
        # vectorized prefilter: rows matching a leader that existed at chunk
        # start take the FIRST such hit — exactly the serial walk's answer,
        # since leaders born later in the chunk only get larger indices
        n_old = len(self._leaders)
        if n_old:
            sims = feats @ np.stack(self._leaders).T       # (C, n_old)
            hits = sims >= self.threshold
            has_hit = hits.any(axis=1)
            first = hits.argmax(axis=1)
        for d in range(feats.shape[0]):
            if zero[d]:
                continue
            if n_old and has_hit[d]:
                labels[d] = first[d]
            else:
                labels[d] = self._match(feats[d])
        if counts is not None:
            self._accumulate(labels, counts, est_ext_to_int)
        for g in labels[labels >= 0]:
            self._members[g] += 1
        self._zero_members += int(zero.sum())
        return labels

    def _accumulate(self, labels, counts, est) -> None:
        counts = np.asarray(counts)
        if not np.issubdtype(counts.dtype, np.integer):
            raise TypeError("canonical sums are exact-integer only; "
                            f"got dtype {counts.dtype}")
        D, S, R = counts.shape
        if self._rows is None:
            self._rows = R
        if est is None:
            est = np.broadcast_to(np.arange(R), (D, S, R))
        c64 = counts.astype(np.int64)
        for g in range(len(self._sums)):
            if self._sums[g] is None:
                self._sums[g] = np.zeros(R, np.int64)
        if self._zero_sum is None:
            self._zero_sum = np.zeros(R, np.int64)
        for d in range(D):
            tgt = self._zero_sum if labels[d] < 0 else self._sums[labels[d]]
            np.add.at(tgt, np.asarray(est[d]).reshape(-1), c64[d].reshape(-1))
            if labels[d] < 0:
                self._zero_profiles += S
            else:
                self._profiles[labels[d]] += S

    def resolve_labels(self, labels: np.ndarray) -> np.ndarray:
        """Provisional -1 labels -> the shared zero-feature cluster index
        (the final leader count, dense-clusterer convention)."""
        labels = np.asarray(labels, np.int64).copy()
        labels[labels < 0] = len(self._leaders)
        return labels

    def finalize(self, k_rows: int = 2) -> dict:
        """Close the scan: exact mean canonical profiles (generations in
        creation order, the zero-feature cluster trailing when present) and
        each generation's discovered vulnerable rows."""
        sums = list(self._sums)
        profiles = list(self._profiles)
        members = list(self._members)
        if self._zero_members:
            sums.append(self._zero_sum)
            profiles.append(self._zero_profiles)
            members.append(self._zero_members)
        R = self._rows
        canonical = None
        if R is not None:
            canonical = np.zeros((len(sums), R))
            for g, (s, n) in enumerate(zip(sums, profiles)):
                if s is not None and n:
                    canonical[g] = s.astype(np.float64) / n
        out = {"n_generations": len(self._leaders),
               "members": np.asarray(members, np.int64),
               "n_profiles": np.asarray(profiles, np.int64),
               "canonical": canonical}
        if canonical is not None:
            out["vulnerable_rows"] = [vulnerable_rows(p, k=k_rows)
                                      for p in canonical]
        return out


def onset_profile(profiles: np.ndarray, min_count: float = 32.0) -> np.ndarray:
    """Pick the mildest operating point's canonical profile that shows real
    errors: ``profiles`` is (T, R) over campaign points ordered mild ->
    harsh.  The design-worst rows are the rows that fail FIRST as timing
    shrinks, so they are read off the onset point — at harsher points the
    count maximum migrates to the mid rows (both column parities far from
    their sense amps) and stops marking the vulnerable region.  Falls back
    to the harshest point when nothing ever clears ``min_count`` (the
    no-observed-variation dies, where only the weak-cell outlier fold
    carries shape)."""
    profiles = np.atleast_2d(np.asarray(profiles))
    for t in range(profiles.shape[0]):
        if profiles[t].max() >= min_count:
            return profiles[t]
    return profiles[-1]


def vulnerable_rows(profile: np.ndarray, k: int = 2,
                    min_sep: int | None = None) -> np.ndarray:
    """The discovered latency test region: ``k`` rows of a canonical internal
    profile, picked greedily by error count but at least ``min_sep`` rows
    apart (default R // (2k)).

    The separation constraint is what makes the discovery cover *both* arms
    of the open-bitline V (Fig 3b): the monotone row-index term tilts raw
    counts toward one mat edge, so a plain top-k collapses onto adjacent
    rows at that edge — while the other edge hosts the worst cells of the
    opposite column parity.  Greedy-with-separation lands on both edge rows,
    i.e. exactly DIVA's design test region, without being told the design.
    If the constraint runs out of candidates, the remaining picks fall back
    to the best unpicked rows.  Ascending row order; count ties break on row
    index via the stable sort — deterministic."""
    profile = np.asarray(profile)
    n = len(profile)
    if min_sep is None:
        min_sep = max(1, n // (2 * max(k, 1)))
    order = np.argsort(-profile, kind="stable")
    picked: list[int] = []
    for r in order:
        if len(picked) == k:
            break
        if all(abs(int(r) - p) >= min_sep for p in picked):
            cand = _snap_to_plateau_edge(profile, int(r))
            # two separated picks can share a plateau edge; a duplicate pick
            # would halve the region, so keep the unsnapped row instead
            picked.append(int(r) if cand in picked else cand)
    for r in order:                       # fallback: ignore separation
        if len(picked) == k:
            break
        if int(r) not in picked:
            picked.append(int(r))
    return np.sort(np.asarray(picked[:k]))


def _snap_to_plateau_edge(profile: np.ndarray, r: int) -> int:
    """A pick inside a count-saturated plateau is Poisson luck: every row of
    the plateau measured the same (p ~ 1 at the campaign's harshest point),
    so prefer the plateau's address-extreme member — the monotone distance
    terms put the true worst row at the outer end of its arm.  The plateau is
    the contiguous run around ``r`` within the Poisson noise floor
    (3*sqrt(count)); if it touches an address-space edge, snap there, else
    (a genuine interior peak, or a fully flat profile) keep the pick."""
    n = len(profile)
    tol = 3.0 * np.sqrt(max(float(profile[r]), 1.0))
    lo = r
    while lo > 0 and profile[lo - 1] >= profile[r] - tol:
        lo -= 1
    hi = r
    while hi < n - 1 and profile[hi + 1] >= profile[r] - tol:
        hi += 1
    if lo == 0 and hi == n - 1:
        return r
    if hi == n - 1:
        return hi
    if lo == 0:
        return lo
    return r

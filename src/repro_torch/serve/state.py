"""Fleet-server state: the generation cache and the per-DIMM table store
(a copy of ``repro.serve.state``, numpy).

Two data structures, both sized by what they track (generations are few,
DIMMs are many), both fully serializable as flat dicts of numpy arrays so
``checkpoint.CheckpointManager`` can snapshot a live server mid-ingest:

  * ``GenerationCache`` — the cosine-signature lookup of
    ``discovery.generation.StreamingGenerations`` plus, per generation, the
    discovered EXTERNAL test addresses (the design's DIVA region pushed
    through its recovered scramble).  A telemetry signature that matches a
    cached generation is a HIT: the DIMM's timing table comes from a
    two-row sweep at the cached addresses instead of a discovery campaign.
  * ``FleetState`` — append-only per-DIMM arrays (timing table, generation
    label, serving path, profile timestamp, staleness deadline) with a
    serial index for O(1) queries, growing by capacity doubling.
"""
from __future__ import annotations

import numpy as np

from repro_torch.discovery.generation import StreamingGenerations

# serving-path codes (FleetState.path)
PATH_HIT = 0           # signature matched a cached generation: region sweep
PATH_DISCOVER = 1      # founded a new generation: discovery campaign
PATH_CONVENTIONAL = 2  # no usable signature: conventional every-row sweep

_NO_ROWS = -1          # ext-rows fill for generations awaiting discovery


class GenerationCache:
    """Per-generation canonical state keyed by the streaming clusterer's
    labels: leader features (the cosine lookup) and discovered external test
    rows.  ``match`` is ``StreamingGenerations.update`` — chunks must arrive
    in serial order, and a restored cache reproduces the exact label
    sequence because matching depends only on the leader list."""

    def __init__(self, threshold: float = 0.85):
        self.gens = StreamingGenerations(threshold=threshold)
        self._ext_rows: dict[int, np.ndarray] = {}
        self._verified: set[int] = set()
        self.hits = 0
        self.misses = 0
        self.conventional = 0

    @property
    def n_generations(self) -> int:
        return self.gens.n_leaders

    def match(self, features: np.ndarray) -> np.ndarray:
        """(C,) provisional labels for one chunk of (C, F) features
        (-1 = zero feature, the no-observed-variation DIMMs)."""
        return self.gens.update(features)

    def known(self, label: int) -> bool:
        return int(label) in self._ext_rows

    def verified(self, label: int) -> bool:
        """Whether the generation's cached region is trustworthy — founded
        from a member whose campaign onset genuinely cleared the signal
        floor.  Unverified generations keep their labels for cluster
        accounting, but members are served by the conventional sweep."""
        return int(label) in self._verified

    def ext_rows(self, label: int) -> np.ndarray:
        """(K,) cached external test addresses of one generation."""
        return self._ext_rows[int(label)]

    def install(self, label: int, ext_rows: np.ndarray, *,
                verified: bool = True) -> None:
        self._ext_rows[int(label)] = np.asarray(ext_rows, np.int64).copy()
        if verified:
            self._verified.add(int(label))
        else:
            self._verified.discard(int(label))

    # ------------------------------------------------------- serialization

    def state_dict(self) -> dict[str, np.ndarray]:
        G = self.gens.n_leaders
        F = len(self.gens._leaders[0]) if G else 0
        leaders = np.zeros((G, F), np.float64)
        for g, lead in enumerate(self.gens._leaders):
            leaders[g] = lead
        K = max((len(v) for v in self._ext_rows.values()), default=0)
        rows = np.full((G, K), _NO_ROWS, np.int64)
        for g, v in self._ext_rows.items():
            rows[g, :len(v)] = v
        members = np.asarray(self.gens._members, np.int64)
        verified = np.asarray([int(g in self._verified) for g in range(G)],
                              np.int8)
        counters = np.asarray(
            [self.hits, self.misses, self.conventional], np.int64)
        return {"leaders": leaders, "ext_rows": rows, "members": members,
                "verified": verified, "counters": counters}

    def load_state(self, state: dict[str, np.ndarray]) -> None:
        leaders = np.asarray(state["leaders"], np.float64)
        G = leaders.shape[0]
        self.gens._leaders = [leaders[g].copy() for g in range(G)]
        self.gens._sums = [None] * G
        self.gens._profiles = [0] * G
        self.gens._members = [int(m) for m in
                              np.asarray(state["members"], np.int64)]
        rows = np.asarray(state["ext_rows"], np.int64)
        self._ext_rows = {g: rows[g][rows[g] != _NO_ROWS].copy()
                          for g in range(G) if (rows[g] != _NO_ROWS).any()}
        self._verified = {g for g, v in enumerate(
            np.asarray(state["verified"], np.int8)) if v}
        self.hits, self.misses, self.conventional = (
            int(v) for v in np.asarray(state["counters"], np.int64))


class FleetState:
    """Append-only per-DIMM serving state (struct-of-arrays, capacity
    doubling) with an O(1) serial index."""

    _FIELDS = (("serial", np.int64, ()), ("table", np.float32, (4,)),
               ("label", np.int64, ()), ("path", np.int8, ()),
               ("profiled_at", np.float32, ()), ("due_at", np.float32, ()),
               ("horizon", np.float32, ()))

    def __init__(self):
        self.n = 0
        self._cap = 0
        for name, dtype, tail in self._FIELDS:
            setattr(self, "_" + name, np.zeros((0,) + tail, dtype))
        self.index: dict[int, int] = {}

    def __len__(self) -> int:
        return self.n

    def _grow(self, need: int) -> None:
        if self.n + need <= self._cap:
            return
        cap = max(self._cap * 2, self.n + need, 1024)
        for name, dtype, tail in self._FIELDS:
            new = np.zeros((cap,) + tail, dtype)
            new[:self.n] = getattr(self, "_" + name)[:self.n]
            setattr(self, "_" + name, new)
        self._cap = cap

    def view(self, name: str) -> np.ndarray:
        """The live (N, ...) prefix of one field — a view, not a copy."""
        return getattr(self, "_" + name)[:self.n]

    def append(self, serials, tables, labels, paths, profiled_at, due_at,
               horizon) -> np.ndarray:
        """Register one chunk of DIMMs; returns their row indices."""
        serials = np.asarray(serials, np.int64)
        c = len(serials)
        self._grow(c)
        rows = np.arange(self.n, self.n + c)
        vals = dict(serial=serials, table=tables, label=labels, path=paths,
                    profiled_at=profiled_at, due_at=due_at, horizon=horizon)
        for name, dtype, tail in self._FIELDS:
            getattr(self, "_" + name)[rows] = np.asarray(vals[name], dtype)
        for i, s in zip(rows, serials):
            if int(s) in self.index:
                raise ValueError(f"serial {int(s)} already registered")
            self.index[int(s)] = int(i)
        self.n += c
        return rows

    def rows_for(self, serials) -> np.ndarray:
        return np.asarray([self.index[int(s)] for s in np.atleast_1d(serials)])

    def update_rows(self, rows, tables, profiled_at, due_at) -> None:
        rows = np.asarray(rows)
        self._table[rows] = np.asarray(tables, np.float32)
        self._profiled_at[rows] = np.float32(profiled_at)
        self._due_at[rows] = np.asarray(due_at, np.float32)

    # ------------------------------------------------------- serialization

    def state_dict(self) -> dict[str, np.ndarray]:
        return {name: self.view(name).copy()
                for name, _, _ in self._FIELDS}

    def load_state(self, state: dict[str, np.ndarray]) -> None:
        serials = np.asarray(state["serial"], np.int64)
        self.n = 0
        self._cap = 0
        for name, dtype, tail in self._FIELDS:
            setattr(self, "_" + name,
                    np.asarray(state[name], dtype).reshape(
                        (len(serials),) + tail).copy())
        self.n = self._cap = len(serials)
        self.index = {int(s): i for i, s in enumerate(serials)}

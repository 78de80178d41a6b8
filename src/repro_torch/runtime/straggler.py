"""DIVA-style canary probing for straggler detection (see ARCHITECTURE.md).

A copy of ``repro.runtime.straggler`` (numpy only, every ``default_rng``
stream kept), so that the port's ``launch.train`` gives the reference's
verdicts without importing it.

The paper's argument transplanted: the slowest path in a TPU pod-of-pods is
*design-induced* — the cross-pod ICI hop plus the largest per-step collective
— so instead of profiling every device/link (the "conventional profiling"
analogue, O(devices) probes), the runtime periodically probes only that
known-worst path and sets the global step timeout from it plus a one-step
guardband. Devices that then exceed the bound are true stragglers (the
"process variation" analogue) and get mitigated (e.g. backup dispatch).

``ClusterSim`` provides a simulated cluster for tests: per-device base
latencies (design: distance-to-pod-edge term) + noise + injected stragglers
+ slow drift (the aging analogue that static thresholds miss).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class ClusterSim:
    n_pods: int = 2
    devices_per_pod: int = 256
    base_ms: float = 10.0
    cross_pod_ms: float = 4.0      # design-induced: cross-pod hop cost
    intra_spread_ms: float = 1.0   # design-induced: distance to pod edge
    noise_ms: float = 0.4
    drift_ms_per_kstep: float = 0.5   # slow fleet-wide drift (aging analogue)
    seed: int = 0
    stragglers: dict = field(default_factory=dict)  # device -> extra ms

    def __post_init__(self):
        self.rng = np.random.default_rng(self.seed)
        n = self.n_pods * self.devices_per_pod
        pos = np.arange(n) % self.devices_per_pod
        # design-induced structure: devices farther from the pod-edge switch
        # pay more on the reduction tree.  The cross-pod hop is modeled as
        # the global cross_pod_ms term in step_latencies/probe (every step
        # pays the worst collective's hop), not as a per-device offset.
        self.design = (pos / self.devices_per_pod) * self.intra_spread_ms
        self.step_count = 0

    @property
    def n_devices(self) -> int:
        return self.n_pods * self.devices_per_pod

    def worst_path_device(self) -> int:
        """The design-worst device: pod-edge-farthest in the last pod."""
        return int(np.argmax(self.design))

    def step_latencies(self) -> np.ndarray:
        """Per-device step time (ms) for one training step."""
        drift = self.step_count / 1000.0 * self.drift_ms_per_kstep
        lat = self.base_ms + self.design + drift \
            + (self.cross_pod_ms if self.n_pods > 1 else 0.0) \
            + self.rng.normal(0, self.noise_ms, self.n_devices)
        for dev, extra in self.stragglers.items():
            lat[dev] += extra
        self.step_count += 1
        return lat

    def probe(self, device: int) -> float:
        """Probe one device's path (a canary collective on the worst route).
        A probed straggler must LOOK like a straggler: injected extras ride
        the probe exactly as they ride ``step_latencies`` — otherwise a
        degraded canary device reads healthy and the timeout tracks a
        fiction."""
        drift = self.step_count / 1000.0 * self.drift_ms_per_kstep
        return float(self.base_ms + self.design[device] + drift
                     + self.stragglers.get(device, 0.0)
                     + (self.cross_pod_ms if self.n_pods > 1 else 0.0)
                     + abs(self.rng.normal(0, self.noise_ms)))


@dataclass
class CanaryProber:
    """Probe the design-worst path every ``period`` steps; timeout = probe *
    margin. Detect stragglers as devices exceeding the timeout."""
    cluster: ClusterSim
    period: int = 100
    margin: float = 1.25
    n_probes: int = 3
    _timeout_ms: float = float("inf")
    _step: int = 0

    def maybe_reprobe(self) -> float:
        if self._step % self.period == 0:
            dev = self.cluster.worst_path_device()
            probes = [self.cluster.probe(dev) for _ in range(self.n_probes)]
            self._timeout_ms = max(probes) * self.margin
        self._step += 1
        return self._timeout_ms

    @property
    def timeout_ms(self) -> float:
        return self._timeout_ms

    def run_step(self) -> dict:
        """One step: returns straggler verdicts + the step time the scheduler
        would see with backup-dispatch mitigation (ignore stragglers beyond
        the timeout, at the cost of a re-dispatch equal to the timeout)."""
        timeout = self.maybe_reprobe()
        lat = self.cluster.step_latencies()
        stragglers = np.where(lat > timeout)[0]
        t_no_mitigation = float(lat.max())
        t_mitigated = float(min(lat.max(), timeout * 2.0)) if len(stragglers) else t_no_mitigation
        return {"timeout_ms": timeout, "stragglers": stragglers.tolist(),
                "step_ms_unmitigated": t_no_mitigation,
                "step_ms_mitigated": t_mitigated}


def conventional_probe_cost(cluster: ClusterSim, n_probes: int = 3) -> int:
    """Probes needed to bound the fleet the conventional way: every device."""
    return cluster.n_devices * n_probes


def diva_probe_cost(n_probes: int = 3) -> int:
    """DIVA-style: only the design-worst path."""
    return n_probes

"""Memory-system simulator on PyTorch: channel -> rank -> bank FR-FCFS
scheduling on top of the per-bank DIVA timing tables (Fig 19).

``sim`` holds the simulator (the FR-FCFS grid through the ``bank_sched``
kernel, and the in-order walker as its 1-deep configuration); ``reference``
the per-request numpy walkers it reproduces bit for bit.
"""
from repro_torch.memsim.sim import (CPU_GHZ, MLP_OVERLAP, WORKLOADS,
                                    MemSimConfig, Workload, evaluate_system,
                                    evaluate_system_grid, inorder_config, ipc,
                                    make_trace, make_trace_loop, simulate,
                                    simulate_trace, speedup_summary,
                                    system_speedup_population, timing_cycles,
                                    timing_cycles_banks, weighted_speedup)
from repro_torch.memsim import reference

__all__ = [
    "CPU_GHZ", "MLP_OVERLAP", "WORKLOADS", "MemSimConfig", "Workload",
    "evaluate_system", "evaluate_system_grid", "inorder_config", "ipc",
    "make_trace", "make_trace_loop", "reference", "simulate",
    "simulate_trace", "speedup_summary", "system_speedup_population",
    "timing_cycles", "timing_cycles_banks", "weighted_speedup",
]

"""The runtime around training: the DIVA-style canary straggler monitor.
The reference's gradient compression and elastic mesh planning (jax, pod and
mesh axes) wait for the multi-GPU slice (ROADMAP queue 1 #5)."""
from repro_torch.runtime.straggler import (CanaryProber, ClusterSim, conventional_probe_cost,
                                           diva_probe_cost)

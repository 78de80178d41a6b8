"""The runtime around training: the DIVA-style canary straggler monitor.
The reference's gradient compression and elastic mesh planning (jax, pod and
mesh axes) wait for the training-side multi-GPU pieces (ROADMAP queue 1 #3)."""
from repro_torch.runtime.straggler import (CanaryProber, ClusterSim, conventional_probe_cost,
                                           diva_probe_cost)

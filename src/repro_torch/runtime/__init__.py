"""The runtime around training: the DIVA-style canary straggler monitor,
int8 gradient compression with error feedback, and elastic mesh planning."""
from repro_torch.runtime.compression import (compress_grads, compression_ratio, decompress_grads,
                                             init_compression_state)
from repro_torch.runtime.elastic import make_elastic_mesh, plan_elastic_mesh
from repro_torch.runtime.straggler import (CanaryProber, ClusterSim, conventional_probe_cost,
                                           diva_probe_cost)

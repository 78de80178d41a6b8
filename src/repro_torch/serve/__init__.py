"""Fleet-scale DIVA serving layer: online timing-table queries over a live
DIMM fleet (signature-cache hits, discovery on miss, staleness-driven
re-profiling, checkpointed state) — the counterpart of ``repro.serve``."""
from repro_torch.serve.server import (FleetConfig, FleetServer,
                                      concat_batches, take_batch)
from repro_torch.serve.state import (PATH_CONVENTIONAL, PATH_DISCOVER,
                                     PATH_HIT, FleetState, GenerationCache)

__all__ = ["FleetConfig", "FleetServer", "FleetState", "GenerationCache",
           "PATH_CONVENTIONAL", "PATH_DISCOVER", "PATH_HIT",
           "concat_batches", "take_batch"]

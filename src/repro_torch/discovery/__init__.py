"""Blind discovery on PyTorch (the reference's ``repro.discovery``).

Population-scale blind characterization: from raw per-row error counts —
observed through an unknown vendor scramble — to a deployable DIVA timing
table, without geometry metadata.  Sec 5.3 / Figs 10-11 of the paper.

  * ``signatures``  — batched per-address-bit error signatures through the
                      ``bit_signature`` kernel (kernels/bit_signature.py).
  * ``recover``     — ``recover_mapping_population``: permutation+XOR
                      scramble recovery over (D, subarrays) as one program;
                      ``core.mapping.estimate_row_mapping`` is the identical
                      per-subarray reference.
  * ``generation``  — cluster DIMMs into design generations by signature
                      similarity; canonical per-generation vulnerable maps.
  * ``blind``       — ``BlindDiva``: the end-to-end pipeline (errors ->
                      recovered mapping -> discovered regions -> restricted
                      ``profile_population``).
"""
from repro_torch.discovery.blind import BlindDiscovery, BlindDiva
from repro_torch.discovery.generation import (StreamingGenerations,
                                              canonical_internal_profiles,
                                              cluster_generations,
                                              vulnerable_rows)
from repro_torch.discovery.recover import (recover_mapping_loop,
                                           recover_mapping_population,
                                           vote_mapping)
from repro_torch.discovery.signatures import (bit_signature_population,
                                              signature_features)

__all__ = [
    "BlindDiscovery", "BlindDiva", "StreamingGenerations",
    "bit_signature_population", "canonical_internal_profiles",
    "cluster_generations", "recover_mapping_loop",
    "recover_mapping_population", "signature_features", "vote_mapping",
    "vulnerable_rows",
]

"""Reliability codec on PyTorch: SECDED(72,64) with DIVA-style interleaving
over byte blobs (the reference's ``repro.memsys``)."""
from repro_torch.memsys.codec import CodecStats, protect_blob, recover_blob, scrub

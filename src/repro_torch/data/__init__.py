"""Synthetic token batches (``pipeline.make_batch``, the same bits as the
reference's), the training stream ``SyntheticLM`` and its ``Prefetcher``."""
from repro_torch.data.pipeline import Prefetcher, SyntheticLM, make_batch

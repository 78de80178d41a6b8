"""Synthetic token batches (``pipeline.make_batch``), the same bits as the
reference's."""

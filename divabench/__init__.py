"""The benchmark of the PyTorch/CUDA port (``repro_torch``): the DIVA path
at the paper's and at fleet scale.  ``python3 divabench/run.py --help``."""

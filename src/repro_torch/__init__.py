"""PyTorch/CUDA port of the DIVA-DRAM reproduction.

A second package beside the JAX reference ``repro``: it imports torch and
numpy, never jax and nothing of ``repro``.  Entry points run on the CUDA
device unless the caller passes ``device="cpu"``.
"""

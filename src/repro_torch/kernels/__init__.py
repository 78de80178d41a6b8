"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version (``fail_prob``, ``secded``, ``shuffle``, ``bank_sched``); ``ops``
lists them and their launch counts."""

"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version (``fail_prob``, ``fail_prob_op`` and ``fail_prob_rows``, ``secded``,
``shuffle``, ``bank_sched``, ``bit_signature``, ``rc_transient``, ``wkv6``,
``adamw``), each launching at the constants of its ``csrc/*.cu`` source;
``ops`` lists them and their launch counts."""

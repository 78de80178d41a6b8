"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version (``fail_prob``, ``fail_prob_op`` and ``fail_prob_rows``, ``secded``,
``shuffle``, ``bank_sched``, ``bit_signature``, ``rc_transient``, ``wkv6``,
``adamw``);
``registry`` holds them as data with their launch spaces, ``tune`` picks each
call's launch, ``ops`` lists them and their launch counts."""

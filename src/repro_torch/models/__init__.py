"""Models of the port: ``layers`` (norms, init, position embeddings),
``attention``, ``moe``, ``mamba`` (with ``scan_utils``), ``rwkv6``, ``model``
(parameters and the forward pass of every family) and ``cache`` (prefill
and decode)."""

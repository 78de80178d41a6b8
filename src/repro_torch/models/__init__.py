"""Models of the port: ``layers`` (norms, init), ``rwkv6`` (the RWKV-6
block), ``model`` (parameters and the forward pass) and ``cache`` (prefill
and decode).  Only the ssm family (rwkv6) is ported so far."""

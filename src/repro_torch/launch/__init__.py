"""Entry points of the port: ``steps`` (prefill and greedy decode steps) and
``serve`` (batched generation, ``python -m repro_torch.launch.serve``)."""

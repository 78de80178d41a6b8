"""Model configurations of the port: ``base`` (``ModelConfig``,
``ShapeConfig``, ``SHAPES``, ``smoke_reduce``), the ported architectures and
``registry`` (``get_config``, ``get_smoke_config``)."""

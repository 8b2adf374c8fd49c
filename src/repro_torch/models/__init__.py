"""repro_torch.models -- the serving model: configuration (a copy of the
JAX package's), layers, the MLP and the ``Transformer`` module."""

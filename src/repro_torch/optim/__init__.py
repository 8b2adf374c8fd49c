"""repro_torch.optim -- AdamW with float32 masters and top-k gradient
compression, the port of the JAX package's ``repro/optim``."""

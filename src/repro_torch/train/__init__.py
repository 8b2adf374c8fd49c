"""repro_torch.train -- the train step, checkpoints, the trainer and the
fault-tolerance control plane, the port of the JAX package's
``repro/train``."""

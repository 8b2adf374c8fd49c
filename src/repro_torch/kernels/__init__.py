"""repro_torch.kernels -- hand-written CUDA kernels, their wrappers and
the plain PyTorch versions they are held against."""

"""repro_torch.kernels -- hand-written CUDA kernels, their wrappers and
the plain PyTorch versions they are held against.

Wrappers by source under ``csrc/``: ``segment_ops`` (segment_reduce.cu),
``topk_ops`` (similarity_topk.cu), ``bitset_ops`` (bitset_ops.cu),
``pair_ops`` (pair_ops.cu), ``array_ops`` (array_ops.cu),
``bitset_convert`` (bitset_convert.cu), ``harley_seal`` (popcount.cu) and
``block_sparse_attn`` (block_sparse_attn.cu);
``ref`` holds the plain versions and ``ops`` the backend switch.
"""

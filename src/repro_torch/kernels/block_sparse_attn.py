"""Roaring block-sparse decode attention, from
``csrc/block_sparse_attn.cu``: one new query token per sequence over its
KV cache, with a Roaring bitset container row per sequence saying which
key/value blocks are visible.

The kernel walks only the set bits of each row's mask words, so a block
that is not visible costs no load: attention whose cost follows the
bitmap's cardinality, not the cache length (the paper's data structure on
the decode hot path).  It computes the JAX package's Pallas kernel's
function; ``ref.block_sparse_attention_decode`` is its plain version.

On a CUDA tensor :func:`decode_attention` launches the kernel or raises; on
a CPU tensor it takes the plain version.  ``launches`` counts kernel
launches (CPU calls and B = 0 do not count).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, ref

DEFAULT_BLOCK_SIZE = 128
MAX_HEAD_DIM = 256
MAX_SMEM = 232_448          # dynamic shared memory a block may opt into

launches = 0


def reset_launches() -> None:
    """Set the launch count to 0."""
    global launches
    launches = 0


@functools.cache
def _lib():
    """The C entry points, built and bound on first use."""
    lib = _build.library("block_sparse_attn")
    p, i, i64, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                    ctypes.c_float)
    lib.decode_attention_cuda.argtypes = [p, p, p, p, p, p, i, i64, i, i,
                                          i64, i, i, i, f, f, p]
    lib.decode_attention_cuda.restype = ctypes.c_int
    lib.decode_attention_smem.argtypes = [i, i, i]
    lib.decode_attention_smem.restype = ctypes.c_size_t
    return lib


def _check(q, k, v, block_mask_words, kv_len, block_size):
    """Raise unless the inputs are what the kernel takes; returns the
    device.  q (B, H, D), k and v (B, Hkv, S, D) of one type (bfloat16 or
    float32), contiguous, on one CUDA device; H a multiple of Hkv; D a
    multiple of 8 up to 256; block_size a multiple of 32 dividing S; mask
    (B, W) int32 with 32 * W >= S / block_size; kv_len (B,) int32."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"q is on {dev}; the kernel needs CUDA")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"q must be bfloat16 or float32, got {q.dtype}")
    if q.ndim != 3 or k.ndim != 4:
        raise ValueError(f"q must be (B, H, D) and k (B, Hkv, S, D); got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    b, h, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    if tuple(k.shape) != (b, hkv, s, d) or v.shape != k.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} must "
                         f"both be {(b, hkv, s, d)}")
    if hkv == 0 or h % hkv:
        raise ValueError(f"H = {h} is not a multiple of Hkv = {hkv}")
    if d % 8 or not 0 < d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} must be a multiple of 8 up to "
                         f"{MAX_HEAD_DIM}")
    if block_size <= 0 or block_size % 32 or s % block_size:
        raise ValueError(f"block_size {block_size} must be a multiple of 32 "
                         f"that divides S = {s}")
    n_blocks = s // block_size
    if (block_mask_words.ndim != 2 or block_mask_words.shape[0] != b
            or 32 * block_mask_words.shape[1] < n_blocks):
        raise ValueError(f"block_mask_words {tuple(block_mask_words.shape)} "
                         f"must be (B, >= {-(-n_blocks // 32)}) for B = {b}")
    if tuple(kv_len.shape) != (b,):
        raise ValueError(f"kv_len must be ({b},), got {tuple(kv_len.shape)}")
    for name, t in (("k", k), ("v", v), ("block_mask_words",
                                          block_mask_words),
                    ("kv_len", kv_len)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
    for name, t in (("block_mask_words", block_mask_words),
                    ("kv_len", kv_len)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v),
                    ("block_mask_words", block_mask_words),
                    ("kv_len", kv_len)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if k.data_ptr() % 16:
        raise ValueError("k must be 16-byte aligned")
    return dev


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     block_mask_words: torch.Tensor, kv_len: torch.Tensor, *,
                     block_size: int = DEFAULT_BLOCK_SIZE,
                     sm_scale: float | None = None,
                     softcap: float = 0.0) -> torch.Tensor:
    """Single-token decode attention with a Roaring block-visibility mask.

    q: (B, H, D); k, v: (B, Hkv, S, D); block_mask_words: (B, ceil(S/bs/32))
    int32 (bit-reinterpreted uint32 Roaring bitset words); kv_len: (B,)
    int32.  Returns (B, H, D) in q's dtype; rows with no visible position
    are 0."""
    global launches
    if q.device.type == "cpu":
        return ref.block_sparse_attention_decode(
            q, k, v, block_mask_words, kv_len, block_size=block_size,
            sm_scale=sm_scale, softcap=softcap)
    dev = _check(q, k, v, block_mask_words, kv_len, block_size)
    b, h, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    scale = (d ** -0.5) if sm_scale is None else sm_scale
    out = torch.empty_like(q)
    if b == 0:
        return out
    lib = _lib()
    smem = lib.decode_attention_smem(h // hkv, d, block_size)
    if smem > MAX_SMEM:
        raise ValueError(f"{h // hkv} query heads a KV head at D = {d} and "
                         f"block {block_size} need {smem} bytes of shared "
                         f"memory; the card has {MAX_SMEM}")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.decode_attention_cuda(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            block_mask_words.data_ptr(), kv_len.data_ptr(), out.data_ptr(),
            int(q.dtype == torch.bfloat16), b, h, hkv, s, d, block_size,
            block_mask_words.shape[1], scale, softcap, stream)
    if err != 0:
        raise RuntimeError(f"decode_attention_cuda failed: cudaError {err}")
    launches += 1
    return out

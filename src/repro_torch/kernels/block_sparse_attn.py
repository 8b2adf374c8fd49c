"""Roaring block-sparse decode attention, from
``csrc/block_sparse_attn.cu``: one new query token per sequence over its
KV cache, with a Roaring bitset container row per sequence saying which
key/value blocks are visible.

The kernel walks only the set bits of each row's mask words, so a block
that is not visible costs no load: attention whose cost follows the
bitmap's cardinality, not the cache length (the paper's data structure on
the decode hot path).  It computes the JAX package's Pallas kernel's
function; ``ref.block_sparse_attention_decode`` is its plain version.

Flash-decoding: each (sequence, KV head) row's visible keys are split
over P blocks of the grid, which :func:`split_count` picks from the static
shapes alone (the host never reads the mask or kv_len); each block writes
a float32 partial (m, l, acc) and a second kernel merges the P partials in
ascending order, so a call launches two kernels (one when P = 1).
``ref.decode_attention_partials`` and ``ref.combine_partials`` are the
plain versions of the two steps.

On a CUDA tensor :func:`decode_attention` launches the kernel or raises; on
a CPU tensor it takes the plain version; on meta tensors (the dry run's
shapes without storage) it gives the output's shape and charges the
kernel's work to an active ``launch.op_analysis.OpAnalysis`` as a dense
upper bound: every K/V row, since a meta mask and ``kv_len`` have no
values.  ``launches`` counts calls that launch (CPU calls, meta calls and
B = 0 do not count).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, ref

DEFAULT_BLOCK_SIZE = 128
MAX_HEAD_DIM = 256
MAX_SMEM = 232_448          # dynamic shared memory a block may opt into;
                            # the split kernel needs at most 208,992
SM_SMEM = 233_472           # shared memory an SM holds (228 KB)
BLOCKS_PER_SM = 4           # the split kernel's blocks an SM, at most
MAX_SPLITS = 65_535         # the grid's y limit

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
    lib.decode_attention_cuda.argtypes = [p, p, p, p, p, p, p, i, i64, i, i,
                                          i64, i, i, i, i, i, f, f, p]
    lib.decode_attention_cuda.restype = ctypes.c_int
    lib.decode_attention_smem.argtypes = [i, i, i]
    lib.decode_attention_smem.restype = ctypes.c_size_t
    return lib


@functools.cache
def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _heads_per_block(g: int) -> int:
    """Query heads of one KV head that one block of the grid holds: the
    least of 1, 2, 4, 8 that covers g, else 8."""
    return next((c for c in (1, 2, 4) if g <= c), 8)


def split_count(b: int, hkv: int, g: int, s: int, block_size: int,
                sms: int, smem: int) -> int:
    """P, the grid blocks a (sequence, KV head) row's visible keys are
    split over: as many as fill one wave of the card (``sms`` SMs, each
    holding ``BLOCKS_PER_SM`` blocks, or fewer of ``smem`` bytes), at
    least 1 and at most the row's block count.  From static shapes only:
    a wave and a tail of blocks is slower than one full wave
    (``chip_smoke.py`` phase 2g times P = 1, 4, 8, 9, 16 and 64 at
    Gemma2-27B's decode shape)."""
    rows = b * hkv * -(-g // _heads_per_block(g))
    per_sm = max(1, min(BLOCKS_PER_SM, SM_SMEM // (smem + 1024)))
    return max(1, min(per_sm * sms // max(rows, 1), s // block_size,
                      MAX_SPLITS))


def _check(q, k, v, block_mask_words, kv_len, block_size):
    """Raise unless the inputs are what the kernel takes; returns the
    device.  q (B, H, D), k and v (B, Hkv, S, D) of one type (bfloat16 or
    float32), contiguous, on one CUDA device, k and v 16-byte aligned
    (the kernel reads their rows with 16-byte cp.async); H a multiple of
    Hkv; D a multiple of 8 up to 256; block_size a multiple of 32 dividing
    S; mask (B, W) int32 with 32 * W >= S / block_size; kv_len (B,)
    int32."""
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
    for name, t in (("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    return dev


def _launch(q, k, v, block_mask_words, kv_len, block_size, sm_scale,
            softcap, splits):
    """Check, launch, count: (out, partials (B, H, P, D + 2) float32 or
    None when P = 1)."""
    global launches
    dev = _check(q, k, v, block_mask_words, kv_len, block_size)
    b, h, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    g = h // hkv
    scale = (d ** -0.5) if sm_scale is None else sm_scale
    out = torch.empty_like(q)
    if b == 0:
        return out, None
    gh = _heads_per_block(g)
    lib = _lib()
    smem = lib.decode_attention_smem(gh, d, q.element_size())
    if smem > MAX_SMEM:
        raise ValueError(f"{gh} query heads a block at D = {d} need {smem} "
                         f"bytes of shared memory; the card has {MAX_SMEM}")
    if splits is None:
        splits = split_count(b, hkv, g, s, block_size, _sm_count(dev), smem)
    elif not 1 <= splits <= MAX_SPLITS:
        raise ValueError(f"splits = {splits} outside [1, {MAX_SPLITS}]")
    part = (torch.empty((b, h, splits, d + 2), dtype=torch.float32,
                        device=dev) if splits > 1 else None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.decode_attention_cuda(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            block_mask_words.data_ptr(), kv_len.data_ptr(), out.data_ptr(),
            None if part is None else part.data_ptr(),
            int(q.dtype == torch.bfloat16), b, h, hkv, s, d, block_size,
            block_mask_words.shape[1], gh, splits, scale, softcap, stream)
    if err != 0:
        raise RuntimeError(f"decode_attention_cuda failed: cudaError {err}")
    launches += 1
    return out, part


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     block_mask_words: torch.Tensor, kv_len: torch.Tensor, *,
                     block_size: int = DEFAULT_BLOCK_SIZE,
                     sm_scale: float | None = None,
                     softcap: float = 0.0,
                     splits: int | None = None) -> torch.Tensor:
    """Single-token decode attention with a Roaring block-visibility mask.

    q: (B, H, D); k, v: (B, Hkv, S, D); block_mask_words: (B, ceil(S/bs/32))
    int32 (bit-reinterpreted uint32 Roaring bitset words); kv_len: (B,)
    int32.  Returns (B, H, D) in q's dtype; rows with no visible position
    are 0.  ``splits`` forces P (default :func:`split_count`)."""
    if q.device.type == "cpu":
        return ref.block_sparse_attention_decode(
            q, k, v, block_mask_words, kv_len, block_size=block_size,
            sm_scale=sm_scale, softcap=softcap)
    if q.device.type == "meta":
        return _meta_shape(q, k, v, block_mask_words, kv_len)
    return _launch(q, k, v, block_mask_words, kv_len, block_size, sm_scale,
                   softcap, splits)[0]


def _meta_shape(q, k, v, block_mask_words, kv_len):
    """The kernel's shape rule on meta tensors: an empty (B, H, D) output,
    and the kernel's work charged as a dense upper bound (every K/V row
    read once; QK and PV products over every position; one exp a
    score)."""
    from repro_torch.launch.op_analysis import charge
    b, h, d = q.shape
    s = k.shape[2]
    out = torch.empty_like(q)
    charge("decode_attention (dense upper bound)",
           flops=4.0 * b * h * s * d,
           bytes=float(sum(t.numel() * t.element_size() for t in (
               q, k, v, block_mask_words, kv_len, out))),
           transcendentals=float(b * h * s))
    return out


def decode_attention_with_partials(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        block_mask_words: torch.Tensor, kv_len: torch.Tensor, *,
        block_size: int = DEFAULT_BLOCK_SIZE, sm_scale: float | None = None,
        softcap: float = 0.0, splits: int | None = None
        ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """:func:`decode_attention` that also returns the split step's float32
    partials (B, H, P, D + 2), each row (m, l, acc), or None when P = 1:
    for checking the two steps against ``ref.decode_attention_partials``
    and ``ref.combine_partials``.  On a CPU tensor, those plain versions
    (P from ``splits``, default 1)."""
    if q.device.type == "cpu":
        n = splits or 1
        part = ref.decode_attention_partials(
            q, k, v, block_mask_words, kv_len, n, block_size=block_size,
            sm_scale=sm_scale, softcap=softcap)
        return ref.combine_partials(part).to(q.dtype), \
            (part if n > 1 else None)
    return _launch(q, k, v, block_mask_words, kv_len, block_size, sm_scale,
                   softcap, splits)

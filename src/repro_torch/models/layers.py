"""Shared neural layers of the serving path: norms, RoPE, chunked flash
attention (prefill), and decode attention (dense, and Roaring block-sparse
through ``kernels.ops.decode_attention``).

The port of the JAX package's ``repro/models/layers.py``, in its
arithmetic: every product that JAX runs with
``preferred_element_type=float32`` upcasts both sides to float32 here (a
bfloat16 ``torch.matmul`` would round the result), softmax statistics are
float32, and the probabilities drop to the value dtype for the PV product as
they do there.  The sharding notes (``ctx.constrain``) are no-ops on one
device and are dropped.  Parameters are the attributes of the module ``p``
(``models.transformer.Attention``), stored in the compute dtype; norm
scales stay float32.  ``weight`` and ``fill`` make every module's
parameters.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import ops as kops

_NEG = -1e30


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def param(t: torch.Tensor) -> torch.nn.Parameter:
    return torch.nn.Parameter(t, requires_grad=False)      # serving only


def weight(shape, std, dtype, device, generator):
    """A normal(0, std) weight drawn in float32 from ``generator`` and
    stored in ``dtype``; without a generator, uninitialised storage for
    ``load_state_dict``."""
    if generator is None:
        return param(torch.empty(shape, dtype=dtype, device=device))
    return param(torch.randn(shape, generator=generator,
                             device=device).mul_(std).to(dtype))


def fill(shape, value, dtype, device):
    return param(torch.full(shape, value, dtype=dtype, device=device))


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rms_norm(x, scale, eps=1e-6):
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return ((1.0 + scale.float()) * out).to(x.dtype)


def layer_norm(x, scale, bias, eps=1e-6):
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
    out = (x32 - mu) * torch.rsqrt(var + eps)
    return (scale.float() * out + bias.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def _rope_freqs(hd: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, hd, 2, dtype=np.float64) / hd))


def apply_rope(x, positions, theta: float,
               sections: tuple[int, int, int] | None = None):
    """x: (..., S, H, D); positions: (..., S) int.  With one position
    stream the M-RoPE sections rotate exactly as 1-D RoPE (as in the JAX
    package), so ``sections`` is only checked."""
    d = x.shape[-1]
    freqs = torch.from_numpy(_rope_freqs(d, theta).astype(np.float32)).to(
        x.device)
    if sections is not None and sum(sections) != d // 2:
        raise ValueError(f"M-RoPE sections {sections} do not cover {d // 2}")
    ang = positions[..., :, None].float() * freqs
    cos = torch.cos(ang)[..., :, None, :]      # (..., S, 1, d/2)
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# chunked flash attention (prefill)
# ---------------------------------------------------------------------------

def _block_pairs(nq, qc, nk, kc, causal, window, skip):
    """Static (query-block, kv-block) schedule.  With skip=True only block
    pairs that can contain visible positions are visited (exact: a skipped
    pair has every score masked)."""
    pairs = []
    for i in range(nq):
        for j in range(nk):
            if skip:
                if causal and j * kc > i * qc + qc - 1:
                    continue  # entirely in the future
                if window and (j * kc + kc - 1) < (i * qc - window + 1):
                    continue  # entirely out of the window
            pairs.append((i, j))
    return (np.asarray([p[0] for p in pairs], np.int32),
            np.asarray([p[1] for p in pairs], np.int32))


def flash_attention(q, k, v, *, causal=True, window=0, softcap=0.0,
                    scale=None, q_chunk=512, k_chunk=1024, block_skip=False):
    """Memory-bounded attention: O(S * k_chunk) live intermediates.

    q: (B, S, H, D); k, v: (B, S, Hkv, D).  Returns (B, S, H, D).  Each
    query block carries its online-softmax state over its KV blocks in the
    JAX package's schedule order (``_block_pairs``); a query block with no
    pair is 0, as there."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    dv = v.shape[-1]
    g = h // hkv
    scale = (d ** -0.5) if scale is None else scale
    qc, kc = min(q_chunk, s), min(k_chunk, s)
    nq, nk = s // qc, s // kc
    if nq * qc != s or nk * kc != s:
        raise ValueError(f"sequence {s} is not a multiple of the chunks "
                         f"({qc}, {kc})")
    qr = q.reshape(b, nq, qc, hkv, g, d)
    kr = k.reshape(b, nk, kc, hkv, d)
    vr = v.reshape(b, nk, kc, hkv, dv)
    qi, kj = _block_pairs(nq, qc, nk, kc, causal, window, block_skip)
    qpos_in = torch.arange(qc, device=q.device)
    kpos_in = torch.arange(kc, device=q.device)
    out = torch.empty((b, s, h, dv), dtype=q.dtype, device=q.device)
    for i in range(nq):
        m = torch.full((b, hkv, g, qc), _NEG, device=q.device)
        l = torch.zeros((b, hkv, g, qc), device=q.device)
        acc = torch.zeros((b, hkv, g, qc, dv), device=q.device)
        qb = qr[:, i].float()
        for j in kj[qi == i].tolist():
            sc = torch.einsum("bqhgd,bkhd->bhgqk", qb,
                              kr[:, j].float()) * scale
            if softcap:
                sc = softcap * torch.tanh(sc / softcap)
            qpos = i * qc + qpos_in
            kpos = j * kc + kpos_in
            mask = torch.ones((qc, kc), dtype=torch.bool, device=q.device)
            if causal:
                mask &= qpos[:, None] >= kpos[None, :]
            if window:
                mask &= (qpos[:, None] - kpos[None, :]) < window
            sc = torch.where(mask, sc, _NEG)
            m_new = torch.maximum(m, sc.amax(dim=-1))
            p = torch.exp(sc - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = alpha * l + p.sum(dim=-1)
            # probabilities drop to the value dtype for the PV product
            # (float32 accumulation), as in the JAX package
            vb = vr[:, j]
            acc = alpha[..., None] * acc + torch.einsum(
                "bhgqk,bkhd->bhgqd", p.to(vb.dtype).float(), vb.float())
            m = m_new
        o = acc / torch.where(l > 0, l, 1.0)[..., None]
        o = torch.where((l > 0)[..., None], o, 0.0)
        # (b, hkv, g, qc, dv) -> (b, qc, h, dv)
        out[:, i * qc:(i + 1) * qc] = o.permute(0, 3, 1, 2, 4).reshape(
            b, qc, h, dv).to(q.dtype)
    return out


# ---------------------------------------------------------------------------
# decode attention (single new token over a KV cache)
# ---------------------------------------------------------------------------

def decode_attention_dense(q, k_cache, v_cache, kv_len, *,
                           window=0, softcap=0.0, scale=None):
    """q: (B, H, D); caches: (B, Hkv, S, D); kv_len: (B,) -> (B, H, D)."""
    b, h, d = q.shape
    hkv, s = k_cache.shape[1], k_cache.shape[2]
    g = h // hkv
    scale = (d ** -0.5) if scale is None else scale
    qg = q.reshape(b, hkv, g, d).float()
    sc = torch.matmul(qg, k_cache.float().transpose(-1, -2)) * scale
    if softcap:
        sc = softcap * torch.tanh(sc / softcap)
    pos = torch.arange(s, device=q.device)
    valid = pos[None, :] < kv_len[:, None]
    if window:
        valid &= pos[None, :] >= (kv_len[:, None] - window)
    sc = torch.where(valid[:, None, None, :], sc, _NEG)
    w = torch.softmax(sc, dim=-1)
    # the cache stays in its storage dtype for the PV product (one rounding
    # of a float32 accumulation), as in the JAX package
    out = torch.matmul(w.to(v_cache.dtype), v_cache)
    return out.reshape(b, h, d).to(q.dtype)


def decode_attention_roaring(q, k_cache, v_cache, kv_len, block_mask_words,
                             *, block_size=128, scale=None, softcap=0.0,
                             backend=None):
    """Paper-technique decode path: the Roaring block-visibility kernel on
    CUDA tensors, its plain version on the CPU or under ``backend="ref"``."""
    return kops.decode_attention(q, k_cache, v_cache, block_mask_words,
                                 kv_len, block_size=block_size,
                                 sm_scale=scale, softcap=softcap,
                                 backend=backend)


# ---------------------------------------------------------------------------
# attention blocks (projection + rope + attention + output)
# ---------------------------------------------------------------------------

def _project_qkv(x, p, cfg, positions):
    """x: (B, S, d) -> q (B, S, H, hd), k and v (B, S, Hkv, hd)."""
    b, s, d = x.shape

    def proj(w):                          # einsum("bsd,dhk->bshk")
        return (x @ w.reshape(d, -1)).reshape(b, s, w.shape[1], w.shape[2])

    q, k, v = proj(p.wq), proj(p.wk), proj(p.wv)
    if cfg.qkv_bias:
        q = q + p.bq
        k = k + p.bk
        v = v + p.bv
    if cfg.qk_norm:
        q = rms_norm(q, p.q_norm, cfg.norm_eps)
        k = rms_norm(k, p.k_norm, cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta, cfg.m_rope_sections)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.m_rope_sections)
    return q, k, v


def out_proj(o, wo):
    """einsum("...hk,hkd->...d"): o (..., H, hd), wo (H, hd, d)."""
    h, hd, d = wo.shape
    return o.reshape(*o.shape[:-2], h * hd) @ wo.reshape(h * hd, d)


def attn_prefill(x, p, cfg, mixer, positions, k_cache, v_cache):
    """x: (B, S, d) -> (B, S, d); writes the prompt's keys and values into
    the layer's caches (B, Hkv, S_max, hd) in place."""
    q, k, v = _project_qkv(x, p, cfg, positions)
    out = flash_attention(
        q, k, v, causal=(mixer != "enc"),
        window=cfg.sliding_window if mixer == "local" else 0,
        softcap=cfg.attn_softcap, q_chunk=cfg.attn_q_chunk,
        k_chunk=cfg.attn_k_chunk, block_skip=cfg.flash_block_skip)
    s = x.shape[1]
    k_cache[:, :, :s] = k.transpose(1, 2)
    v_cache[:, :, :s] = v.transpose(1, 2)
    return out_proj(out, p.wo)


def attn_decode(x_tok, p, cfg, mixer, k_cache, v_cache, pos,
                block_mask_words=None, backend=None):
    """x_tok: (B, d); caches (B, Hkv, S, hd), contiguous, updated IN PLACE
    at each row's ``pos`` before they are read; pos: (B,) int.  Returns
    (B, d).

    A ``global`` mixer with ``cfg.roaring_sparse_global`` and mask words
    takes the Roaring block-sparse kernel, reading the cache where it lies;
    every other mixer the dense path."""
    x = x_tok[:, None, :]
    q, k, v = _project_qkv(x, p, cfg, positions=pos[:, None])
    rows = torch.arange(x.shape[0], device=x.device)
    col = pos.long()
    k_cache[rows, :, col] = k[:, 0]
    v_cache[rows, :, col] = v[:, 0]
    q = q[:, 0]
    kv_len = pos + 1
    if (mixer == "global" and cfg.roaring_sparse_global
            and block_mask_words is not None):
        if cfg.sparse_topk_blocks:
            raise NotImplementedError(
                "the sparse_topk_blocks gather route is not ported yet "
                "(ROADMAP Queue 1)")
        out = decode_attention_roaring(
            q, k_cache, v_cache, kv_len, block_mask_words,
            block_size=cfg.attn_block_size, scale=cfg.hd ** -0.5,
            softcap=cfg.attn_softcap, backend=backend)
    else:
        out = decode_attention_dense(
            q, k_cache, v_cache, kv_len,
            window=cfg.sliding_window if mixer == "local" else 0,
            softcap=cfg.attn_softcap)
    return out_proj(out, p.wo)

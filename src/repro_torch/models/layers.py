"""Shared neural layers of the serving path: norms, RoPE (M-RoPE sections
checked), chunked flash attention (prefill), decode attention (dense;
Roaring block-sparse through ``kernels.ops.decode_attention``; and the
``sparse_topk_blocks`` gather route), and DeepSeek-V2 multi-head latent
attention (``MLA``).

The port of the JAX package's ``repro/models/layers.py``, in its
arithmetic: every product that JAX runs with
``preferred_element_type=float32`` upcasts both sides to float32 here (a
bfloat16 ``torch.matmul`` would round the result), softmax statistics are
float32, and the probabilities drop to the value dtype for the PV product as
they do there.  The sharding notes (``ctx.constrain``) are kept: they
redistribute DTensors under a device mesh and are identities off it.  Parameters are the attributes of the module ``p``
(``models.transformer.Attention``, ``MLA``), stored in the compute dtype
for serving and as float32 masters for training, and read through
``cast``; norm scales stay float32.  ``weight`` and ``fill`` make every
module's parameters.  ``attn_train`` and ``mla_train`` are the training
forms of the two prefills (the same attention, no cache writes).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.dist import ctx
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import block_mask_bits

_NEG = -1e30


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def param(t: torch.Tensor) -> torch.nn.Parameter:
    # frozen for serving; a trainer turns gradients on for its masters
    return torch.nn.Parameter(t, requires_grad=False)


def cast(w, like):
    """A parameter in ``like``'s dtype at the point of use, as JAX writes
    ``p[...].astype(dt)``: no copy where it is stored in that dtype (the
    serving model), a cast of the float32 master under training, whose
    backward upcasts the compute-dtype gradient."""
    return w.to(like.dtype)


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


class _GatherRows(torch.autograd.Function):
    """``table[ids]`` whose backward adds the rows of repeated ids in their
    order of appearance, in the table's dtype: one ``index_add_`` a round,
    round r adding every id's r-th occurrence, so each round's ids are
    distinct.  That is the sequential sum XLA's scatter computes for the
    JAX package's gather, and it is the same on every run and device (the
    CPU's accumulating ``index_put_``, which ``table[ids]`` differentiates
    through, adds repeats in parallel).  The rounds are as many as the
    most repeated id's count; one host sync reads their sizes.  Meta
    tensors (the dry run) have no sizes to read: there one ``index_add_``
    adds every row, the bytes of all the rounds together, since the
    rounds partition the rows."""

    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.rows = table.shape[0]
        return table[ids]

    @staticmethod
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        flat = ids.reshape(-1)
        g = grad.reshape(flat.numel(), grad.shape[-1])
        order = torch.sort(flat, stable=True).indices
        sid = flat[order]
        pos = torch.arange(sid.numel(), device=sid.device)
        first = torch.ones_like(sid, dtype=torch.bool)
        first[1:] = sid[1:] != sid[:-1]
        rank = pos - torch.cummax(torch.where(first, pos, 0), 0).values
        by_round = torch.sort(rank, stable=True).indices   # round, then id
        sid, order = sid[by_round], order[by_round]
        out = torch.zeros((ctx.rows, g.shape[1]), dtype=g.dtype,
                          device=g.device)
        if g.device.type == "meta":
            return out.index_add_(0, sid, g[order]), None
        start = 0
        for n in torch.bincount(rank).tolist():
            out.index_add_(0, sid[start:start + n],
                           g[order[start:start + n]])
            start += n
        return out, None


def gather_rows(table, ids):
    """``table[ids]`` (ids int64) with a deterministic backward.  Under a
    device mesh its data-dependent backward (a sort, ``bincount``, host
    round sizes) has no DTensor sharding strategy: the table and ids are
    replicated for it (``ctx.local_map``)."""
    return ctx.local_map(_GatherRows.apply, (table, {}), (ids, {}))


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
    # keep attention tiles tensor-parallel under a mesh (the JAX package's
    # constraints; identities off the mesh)
    dp = ctx.dp_axes()
    plan = ctx.attn_head_plan(hkv, g, qc)
    qdims, kdims, cdims = {0: dp}, {0: dp}, {0: dp}  # carry (b, hkv, g, qc)
    if plan == "hkv":
        qdims[3] = kdims[3] = cdims[1] = "model"
    elif plan == "g":
        qdims[4] = cdims[2] = "model"
    elif plan == "qc":
        qdims[2] = cdims[3] = "model"
    if plan != "auto":
        # "auto" leaves the head sharding to the projections, as JAX does;
        # the fresh carry (which GSPMD would shard by its use) keeps the
        # batch sharding
        qr = ctx.constrain(qr, qdims)
        kr = ctx.constrain(kr, kdims)
        vr = ctx.constrain(vr, kdims)
    qi, kj = _block_pairs(nq, qc, nk, kc, causal, window, block_skip)
    qpos_in = torch.arange(qc, device=q.device)
    kpos_in = torch.arange(kc, device=q.device)
    # a DTensor output is joined from its blocks (no slice writes into a
    # sharded buffer); a plain one is written in place
    sharded = ctx.is_dtensor(q)
    out = None if sharded else torch.empty((b, s, h, dv), dtype=q.dtype,
                                           device=q.device)
    blocks = []
    for i in range(nq):
        m = ctx.full((b, hkv, g, qc), _NEG, q, cdims)
        l = ctx.full((b, hkv, g, qc), 0.0, q, cdims)
        acc = ctx.full((b, hkv, g, qc, dv), 0.0, q, cdims)
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
        o = o.permute(0, 3, 1, 2, 4).reshape(b, qc, h, dv).to(q.dtype)
        if sharded:
            blocks.append(o)
        else:
            out[:, i * qc:(i + 1) * qc] = o
    return torch.cat(blocks, dim=1) if sharded else out


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
    CUDA tensors, its plain version on the CPU or under ``backend="ref"``.
    Under a device mesh the kernel (a ``ctypes`` launch, no DTensor
    strategy) runs on each device's shards (``ctx.local_map``): the batch
    over the data axes, the KV heads and their query groups over the model
    axis where it divides them."""
    ms = ctx.model_axis_size()
    head = "model" if ms > 1 and k_cache.shape[1] % ms == 0 else None
    dp = ctx.dp_axes()
    return ctx.local_map(
        lambda q_, k_, v_, w_, n_: kops.decode_attention(
            q_, k_, v_, w_, n_, block_size=block_size, sm_scale=scale,
            softcap=softcap, backend=backend),
        (q, {0: dp, 1: head}), (k_cache, {0: dp, 1: head}),
        (v_cache, {0: dp, 1: head}), (block_mask_words, {0: dp}),
        (kv_len, {0: dp}))


def visible_block_ids(block_mask_words, kv_len, n_blocks, block_size, topk):
    """Roaring words (B, W) int32 -> the first ``topk`` visible block ids of
    each row in ascending order (B, topk) int32, 0 past the row's count,
    and the counts min(visible, topk) (B,).  A block is visible when its
    bit is set and it starts below ``kv_len``; the rank is the prefix sum
    of the visibility row (the paper's section 3.1 extraction)."""
    vis = block_mask_bits(block_mask_words, n_blocks)
    blocks = torch.arange(n_blocks, device=vis.device)
    vis &= (blocks * block_size)[None, :] < kv_len.to(vis.device)[:, None]
    rank = torch.cumsum(vis, dim=1) - 1
    # ranks past topk and invisible blocks land in the spare last column
    dst = torch.where(vis & (rank < topk), rank, topk)
    idx = torch.zeros((vis.shape[0], topk + 1), dtype=torch.int32,
                      device=vis.device)
    idx.scatter_(1, dst, blocks.to(torch.int32).expand_as(dst))
    return idx[:, :topk], torch.clamp(vis.sum(dim=1), max=topk)


def decode_attention_block_gather(q, k_cache, v_cache, kv_len,
                                  block_mask_words, *, block_size=128,
                                  topk=64, scale=None, softcap=0.0):
    """The portable Roaring block-sparse decode: the visible block ids from
    the mask words (``visible_block_ids``), a gather of only those K and V
    blocks, and attention over the gathered window.

    q: (B, H, D); caches (B, Hkv, S, D); block_mask_words (B, W) int32;
    kv_len (B,).  Returns (B, H, D) in q's dtype.  Only the first
    ``topk`` visible blocks of a row count, so with more visible blocks
    than ``topk`` this is another function than row 17's; and the softmax
    weights drop to the value dtype before the PV product, as in the JAX
    package, where row 17 keeps them in float32.  A row with no visible
    block attends uniformly over the gathered block 0 repeated (-1e30
    everywhere), as there."""
    b, h, d = q.shape
    hkv, s = k_cache.shape[1], k_cache.shape[2]
    g = h // hkv
    nblk = s // block_size
    topk = min(topk, nblk)
    scale = (d ** -0.5) if scale is None else scale
    idx, n_vis = visible_block_ids(block_mask_words, kv_len, nblk,
                                   block_size, topk)
    rows = torch.arange(b, device=q.device)[:, None]
    # (B, topk, Hkv, bs, D): only the addressed blocks are read
    k_sel = k_cache.reshape(b, hkv, nblk, block_size, d)[rows, :, idx.long()]
    v_sel = v_cache.reshape(b, hkv, nblk, block_size, d)[rows, :, idx.long()]
    qg = q.reshape(b, hkv, g, d).float()
    sc = torch.einsum("bhgd,bthsd->bhgts", qg, k_sel.float()) * scale
    if softcap:
        sc = softcap * torch.tanh(sc / softcap)
    pos = idx[:, :, None] * block_size + torch.arange(block_size,
                                                      device=q.device)
    valid = (torch.arange(topk, device=q.device)[None, :, None]
             < n_vis[:, None, None]) & (pos < kv_len[:, None, None])
    sc = torch.where(valid[:, None, None], sc, _NEG)
    w = torch.softmax(sc.reshape(b, hkv, g, topk * block_size), dim=-1)
    w = w.reshape(b, hkv, g, topk, block_size).to(v_sel.dtype)
    out = torch.einsum("bhgts,bthsd->bhgd", w.float(), v_sel.float())
    return out.reshape(b, h, d).to(q.dtype)


# ---------------------------------------------------------------------------
# attention blocks (projection + rope + attention + output)
# ---------------------------------------------------------------------------

def _project_qkv(x, p, cfg, positions):
    """x: (B, S, d) -> q (B, S, H, hd), k and v (B, S, Hkv, hd)."""
    b, s, d = x.shape

    def proj(w):                          # einsum("bsd,dhk->bshk")
        return (x @ cast(w, x).reshape(d, -1)).reshape(
            b, s, w.shape[1], w.shape[2])

    q, k, v = proj(p.wq), proj(p.wk), proj(p.wv)
    if cfg.qkv_bias:
        q = q + cast(p.bq, q)
        k = k + cast(p.bk, k)
        v = v + cast(p.bv, v)
    if cfg.qk_norm:
        q = rms_norm(q, p.q_norm, cfg.norm_eps)
        k = rms_norm(k, p.k_norm, cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta, cfg.m_rope_sections)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.m_rope_sections)
    return q, k, v


def out_proj(o, wo):
    """einsum("...hk,hkd->...d"): o (..., H, hd), wo (H, hd, d)."""
    h, hd, d = wo.shape
    return o.reshape(*o.shape[:-2], h * hd) @ cast(wo, o).reshape(h * hd, d)


def _attend(q, k, v, cfg, mixer):
    return flash_attention(
        q, k, v, causal=(mixer != "enc"),
        window=cfg.sliding_window if mixer == "local" else 0,
        softcap=cfg.attn_softcap, q_chunk=cfg.attn_q_chunk,
        k_chunk=cfg.attn_k_chunk, block_skip=cfg.flash_block_skip)


def attn_train(x, p, cfg, mixer, positions):
    """x: (B, S, d) -> (B, S, d): the JAX package's ``attn_train``, the
    prefill's attention without the cache writes, differentiable."""
    q, k, v = _project_qkv(x, p, cfg, positions)
    return out_proj(_attend(q, k, v, cfg, mixer), p.wo)


def attn_prefill(x, p, cfg, mixer, positions, k_cache, v_cache):
    """x: (B, S, d) -> (B, S, d); writes the prompt's keys and values into
    the layer's caches (B, Hkv, S_max, hd) in place."""
    q, k, v = _project_qkv(x, p, cfg, positions)
    out = _attend(q, k, v, cfg, mixer)
    dims = {0: 0, 1: 1, 2: 2, 3: 3}
    ctx.write_local(_write_prefix, k_cache, (k.transpose(1, 2), dims))
    ctx.write_local(_write_prefix, v_cache, (v.transpose(1, 2), dims))
    return out_proj(out, p.wo)


def _write_prefix(cache, new):
    """The prompt's entries into the cache's first positions, in place: a
    KV cache (B, Hkv, S_max, hd) from (B, Hkv, S, hd), or an MLA cache
    (B, S_max, c) from (B, S, c)."""
    if cache.dim() == 4:
        cache[:, :, :new.shape[2]] = new
    else:
        cache[:, :new.shape[1]] = new


def _write_column(cache, new, pos):
    """cache[b, ..., pos[b]] = new[b] for each row b, in place: a KV cache
    (B, Hkv, S, hd) column from new (B, Hkv, hd), or an MLA cache (B, S,
    c) row from new (B, c)."""
    rows = torch.arange(cache.shape[0], device=cache.device)
    if cache.dim() == 4:
        cache[rows, :, pos.long()] = new
    else:
        cache[rows, pos.long()] = new


def attn_decode(x_tok, p, cfg, mixer, k_cache, v_cache, pos,
                block_mask_words=None, backend=None):
    """x_tok: (B, d); caches (B, Hkv, S, hd), contiguous, updated IN PLACE
    at each row's ``pos`` before they are read; pos: (B,) int.  Returns
    (B, d).

    A ``global`` mixer with ``cfg.roaring_sparse_global`` and mask words
    takes the Roaring block-sparse kernel, reading the cache where it lies,
    or with ``cfg.sparse_topk_blocks`` the gather route
    (``decode_attention_block_gather``, plain PyTorch on every device);
    every other mixer the dense path."""
    x = x_tok[:, None, :]
    q, k, v = _project_qkv(x, p, cfg, positions=pos[:, None])
    ctx.write_local(_write_column, k_cache, (k[:, 0], {0: 0, 1: 1}),
                    (pos, {0: 0}))
    ctx.write_local(_write_column, v_cache, (v[:, 0], {0: 0, 1: 1}),
                    (pos, {0: 0}))
    q = q[:, 0]
    kv_len = pos + 1
    if (mixer == "global" and cfg.roaring_sparse_global
            and block_mask_words is not None):
        if cfg.sparse_topk_blocks:
            out = decode_attention_block_gather(
                q, k_cache, v_cache, kv_len, block_mask_words,
                block_size=cfg.attn_block_size,
                topk=cfg.sparse_topk_blocks, scale=cfg.hd ** -0.5,
                softcap=cfg.attn_softcap)
        else:
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


# ---------------------------------------------------------------------------
# Multi-head latent attention (DeepSeek-V2)
# ---------------------------------------------------------------------------

class MLA(torch.nn.Module):
    """The MLA mixer's parameters, with JAX's keys, shapes and init scales:
    ``w_dq`` (d, q_lora), ``q_ln`` (q_lora,), ``w_uq`` (q_lora, H, nope +
    rope), ``w_dkv`` (d, kv_lora + rope), ``kv_ln`` (kv_lora,), ``w_uk``
    (kv_lora, H, nope), ``w_uv`` (kv_lora, H, v_head), ``wo`` (H, v_head,
    d).  The two norm scales stay float32."""

    def __init__(self, cfg, dtype, device, generator):
        super().__init__()
        d, h = cfg.d_model, cfg.n_heads
        ql, kl = cfg.q_lora_rank, cfg.kv_lora_rank
        nope, rope_d, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
        f32 = torch.float32
        self.w_dq = weight((d, ql), d ** -0.5, dtype, device, generator)
        self.q_ln = fill((ql,), 0.0, f32, device)
        self.w_uq = weight((ql, h, nope + rope_d), ql ** -0.5, dtype, device,
                           generator)
        self.w_dkv = weight((d, kl + rope_d), d ** -0.5, dtype, device,
                            generator)
        self.kv_ln = fill((kl,), 0.0, f32, device)
        self.w_uk = weight((kl, h, nope), kl ** -0.5, dtype, device,
                           generator)
        self.w_uv = weight((kl, h, vd), kl ** -0.5, dtype, device, generator)
        self.wo = weight((h, vd, d), (h * vd) ** -0.5, dtype, device,
                         generator)


def _heads(x, w):
    """einsum("...k,khn->...hn") in x's dtype: x (..., k), w (k, H, n)."""
    k, h, n = w.shape
    return (x @ cast(w, x).reshape(k, h * n)).reshape(*x.shape[:-1], h, n)


def _mla_q(x, p, cfg, positions):
    """x (B, S, d) -> q_nope (B, S, H, nope), q_rope (B, S, H, rope)."""
    cq = rms_norm(x @ cast(p.w_dq, x), p.q_ln, cfg.norm_eps)
    q = _heads(cq, p.w_uq)
    q_rope = apply_rope(q[..., cfg.qk_nope_dim:], positions, cfg.rope_theta)
    return q[..., :cfg.qk_nope_dim], q_rope


def _mla_ckv(x, p, cfg, positions):
    """x (B, S, d) -> the compressed cache rows: ckv (B, S, kv_lora), normed,
    and k_rope (B, S, rope), one rotary key shared by every head."""
    dkv = x @ cast(p.w_dkv, x)
    kl = cfg.kv_lora_rank
    ckv = rms_norm(dkv[..., :kl], p.kv_ln, cfg.norm_eps)
    k_rope = apply_rope(dkv[..., None, kl:], positions, cfg.rope_theta)
    return ckv, k_rope[:, :, 0]


def _mla_attend(x, p, cfg, positions):
    """x: (B, S, d) -> (the attention output (B, S, d), ckv, k_rope)
    through the decompressed attention: keys and values expanded per head
    from ckv, causal flash attention with qk width nope + rope and v width
    v_head (JAX's ``mla_train``)."""
    b, s, _ = x.shape
    h = cfg.n_heads
    q_nope, q_rope = _mla_q(x, p, cfg, positions)
    ckv, k_rope = _mla_ckv(x, p, cfg, positions)
    k = torch.cat([_heads(ckv, p.w_uk), k_rope[:, :, None, :].expand(
        b, s, h, cfg.qk_rope_dim)], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    out = flash_attention(
        q, k, _heads(ckv, p.w_uv), causal=True,
        scale=(cfg.qk_nope_dim + cfg.qk_rope_dim) ** -0.5,
        q_chunk=cfg.attn_q_chunk, k_chunk=cfg.attn_k_chunk,
        block_skip=cfg.flash_block_skip)
    return out_proj(out, p.wo), ckv, k_rope


def mla_train(x, p, cfg, positions):
    """x: (B, S, d) -> (B, S, d): the JAX package's ``mla_train``, the
    prefill's attention without the cache writes, differentiable."""
    return _mla_attend(x, p, cfg, positions)[0]


def mla_prefill(x, p, cfg, positions, ckv_cache, kr_cache):
    """x: (B, S, d) -> (B, S, d) through ``mla_train``'s attention; writes
    the prompt's ckv and k_rope into the caches (B, S_max, kv_lora) / (B,
    S_max, rope) in place, as JAX's ``_mixer_prefill`` fills them."""
    out, ckv, k_rope = _mla_attend(x, p, cfg, positions)
    ctx.write_local(_write_prefix, ckv_cache, (ckv, {0: 0, 1: 1, 2: 2}))
    ctx.write_local(_write_prefix, kr_cache, (k_rope, {0: 0, 1: 1, 2: 2}))
    return out


def _mla_scores(q_c, q_rope, ckv32, kr, kv_len, cfg):
    """float32 scores (B, H, S) of the absorbed query: q_c . ckv + q_rope .
    k_rope, scaled, -1e30 at and past ``kv_len``; ``ckv32`` is the ckv
    cache already upcast to float32."""
    sc = torch.matmul(q_c.float(), ckv32.transpose(1, 2))
    sc = sc + torch.matmul(q_rope.float(), kr.float().transpose(1, 2))
    sc = sc * ((cfg.qk_nope_dim + cfg.qk_rope_dim) ** -0.5)
    valid = torch.arange(ckv32.shape[1], device=ckv32.device)[None, :] \
        < kv_len[:, None]
    return torch.where(valid[:, None, :], sc, _NEG)


def mla_attend_absorbed(q_nope, q_rope, ckv, kr, kv_len, p, cfg, *,
                        ctx_f32):
    """The absorbed-matrix MLA attention over the compressed caches: q_nope
    (B, H, nope) is folded into the latent space through ``w_uk``, the
    softmax weights read ckv directly, and ``w_uv`` expands the context.
    Returns (B, H, v_head) in q_nope's dtype.

    ``ctx_f32`` picks which of the JAX package's two decode functions this
    is; they differ in bfloat16.  True: ``mla_decode`` (its prefix layers),
    float32 weights times the cache upcast to float32.  False:
    ``mla_decode_stacked`` (its scanned pattern layers), the weights
    rounded to the cache dtype first."""
    dt = q_nope.dtype
    # einsum("bhn,khn->bhk") per head: (H, B, nope) @ (H, nope, kv_lora)
    q_c = (q_nope.transpose(0, 1) @ p.w_uk.permute(1, 2, 0)).transpose(0, 1)
    ckv32 = ckv.float()                 # one upcast for both products
    w = torch.softmax(_mla_scores(q_c, q_rope, ckv32, kr, kv_len, cfg),
                      dim=-1)
    if not ctx_f32:
        w = w.to(ckv.dtype)
    ctx = torch.matmul(w.float(), ckv32).to(dt)              # (B, H, kl)
    # einsum("bhk,khv->bhv"): (H, B, kl) @ (H, kl, v_head)
    return (ctx.transpose(0, 1) @ p.w_uv.transpose(0, 1)).transpose(0, 1)


def mla_attend_decompressed(q_nope, q_rope, ckv, kr, kv_len, p, cfg):
    """The same attention with keys and values decompressed per head, all
    in float32 from the same caches: k_nope = ckv w_uk, v = ckv w_uv.
    The plain check of ``mla_attend_absorbed``; returns (B, H, v_head)
    float32."""
    ckv32 = ckv.float()
    k_nope = torch.einsum("bsk,khn->bhsn", ckv32, p.w_uk.float())
    sc = torch.einsum("bhn,bhsn->bhs", q_nope.float(), k_nope)
    del k_nope
    sc = sc + torch.matmul(q_rope.float(), kr.float().transpose(1, 2))
    sc = sc * ((cfg.qk_nope_dim + cfg.qk_rope_dim) ** -0.5)
    valid = torch.arange(ckv.shape[1], device=ckv.device)[None, :] \
        < kv_len[:, None]
    w = torch.softmax(torch.where(valid[:, None, :], sc, _NEG), dim=-1)
    v = torch.einsum("bsk,khv->bhsv", ckv32, p.w_uv.float())
    return torch.einsum("bhs,bhsv->bhv", w, v)


def mla_decode(x_tok, p, cfg, ckv_cache, kr_cache, pos, *, ctx_f32):
    """Absorbed MLA decode: x_tok (B, d) -> (B, d).  The new token's ckv
    and k_rope are written into the caches (B, S, kv_lora) / (B, S, rope)
    IN PLACE at each row's ``pos`` before they are read; the cache is all
    a layer keeps.  ``ctx_f32``: see ``mla_attend_absorbed``."""
    x = x_tok[:, None, :]
    q_nope, q_rope = _mla_q(x, p, cfg, pos[:, None])
    ckv_new, kr_new = _mla_ckv(x, p, cfg, pos[:, None])
    ctx.write_local(_write_column, ckv_cache, (ckv_new[:, 0], {0: 0}),
                    (pos, {0: 0}))
    ctx.write_local(_write_column, kr_cache, (kr_new[:, 0], {0: 0}),
                    (pos, {0: 0}))
    vout = mla_attend_absorbed(q_nope[:, 0], q_rope[:, 0], ckv_cache,
                               kr_cache, pos + 1, p, cfg, ctx_f32=ctx_f32)
    return out_proj(vout, p.wo)

"""Dense feed-forward and Mixture-of-Experts layers, the port of the JAX
package's ``repro/models/mlp.py``.

``MLP`` holds ``w_gate``, ``w_up`` and ``w_down`` for the gated activations
(swiglu, geglu), ``w_in`` and ``w_out`` for gelu, stored in the compute
dtype.  ``MoE`` holds the JAX keys ``router`` (d, E), ``wg`` and ``wu``
(E, d, ff), ``wd`` (E, ff, d) and, where ``cfg.n_shared_experts`` is set,
``shared.w_gate`` / ``w_up`` / ``w_down``; the router stays float32 (JAX
routes with ``p["router"].astype(float32)`` on float32 inputs), the rest is
stored in the compute dtype for serving, as float32 masters for training,
and read through ``layers.cast``.

MoE dispatches (``cfg.moe_dispatch``):

  * "dense"   -- every expert runs on every token, combined with the
                 routing weights: the oracle.
  * "scatter" -- capacity-bucketed dispatch (the configs' default),
                 within data-parallel groups as in JAX: the T tokens split
                 into G groups of T / G (G the product of the current
                 mesh's data-parallel axis sizes, 1 off the mesh or unless
                 it divides T); each group's k choices a token scatter
                 into its (E, capacity, d) buckets at their token-major,
                 k-minor cumulative position, the experts run as one
                 batched product over every group's buckets, and the
                 outputs gather back within the group with the routing
                 weights.  The capacity is per group.  Choices past an
                 expert's capacity are dropped, as in JAX, and counted in
                 ``dropped_fraction``.  At decode with B = 4, k = 2 and
                 E = 16 the capacity is one token an expert.

Under autograd the scatter dispatch differentiates as JAX's
``.at[dst].set`` and ``take_along_axis`` do: a bucket row's gradient goes
back to the token that wrote it, the spare row of dropped choices is cut
off before the experts run and gives none, and the gather back adds only
a dropped choice's zero to row 0, so its backward's sums do not depend on
their order (remat on and off stay bit-equal).  The router's gradient
comes through the top-k weights and the load-balance loss's mean
probabilities; the expert counts come from the top-k indices and carry
none.

Under a device mesh (DTensor activations) the buckets are sharded over
the groups and the experts as in JAX (``ctx.constrain``), and each
device scatters and gathers its own groups' tokens (``ctx.local_map``
over the groups: the data-dependent scatter has no DTensor sharding
strategy, and needs none, since groups are independent); the
load-balance loss's expert counts are taken on replicated indices.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.dist import ctx
from repro_torch.models.layers import cast, weight


def _const(value, like):
    """A 0-dim constant rounded to ``like``'s dtype, as JAX rounds a weakly
    typed Python float to the array's dtype."""
    return torch.tensor(value, dtype=like.dtype)


def gelu_tanh(x):
    """``jax.nn.gelu`` (its default tanh approximation) op for op in x's
    dtype, with its constants in that dtype.  In bfloat16 the fused
    ``F.gelu(x, approximate="tanh")`` rounds once where JAX rounds after
    every op, and uses sqrt(2/pi) where JAX uses its bfloat16 value
    0.796875: it differs from JAX in about 43% of elements."""
    inner = x + _const(0.044715, x) * x.pow(3)
    cdf = _const(0.5, x) * (_const(1.0, x) + torch.tanh(
        _const(np.sqrt(2 / np.pi), x) * inner))
    return x * cdf


def silu(x):
    """``jax.nn.silu`` as XLA computes it on the CPU: x * (1 / (1 +
    exp(-x))), rounded after every op (XLA expands ``lax.logistic`` so).
    ``x * torch.sigmoid(x)`` rounds the sigmoid once and differs from JAX
    in about 28% of bfloat16 elements."""
    return x * (1 / (1 + torch.exp(-x)))


def _act(x, kind):
    if kind == "swiglu":
        return silu(x)
    return gelu_tanh(x)


# ---------------------------------------------------------------------------
# dense MLP
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    def __init__(self, cfg, dtype, device, generator):
        super().__init__()
        d = cfg.d_model
        ff = cfg.dense_d_ff or cfg.d_ff
        std_in, std_out = d ** -0.5, ff ** -0.5
        if cfg.act in ("swiglu", "geglu"):
            self.w_gate = weight((d, ff), std_in, dtype, device, generator)
            self.w_up = weight((d, ff), std_in, dtype, device, generator)
            self.w_down = weight((ff, d), std_out, dtype, device, generator)
        else:
            self.w_in = weight((d, ff), std_in, dtype, device, generator)
            self.w_out = weight((ff, d), std_out, dtype, device, generator)


def mlp(x, p, cfg):
    if cfg.act in ("swiglu", "geglu"):
        h = _act(x @ cast(p.w_gate, x), cfg.act)
        h.mul_(x @ cast(p.w_up, x))   # in place: no third (tokens, ff) buffer
        return h @ cast(p.w_down, x)
    return _act(x @ cast(p.w_in, x), "gelu") @ cast(p.w_out, x)


# ---------------------------------------------------------------------------
# Mixture of Experts
# ---------------------------------------------------------------------------

class _Shared(nn.Module):
    """The shared experts: one SwiGLU of n_shared_experts * ff."""

    def __init__(self, d, sf, dtype, device, generator):
        super().__init__()
        self.w_gate = weight((d, sf), d ** -0.5, dtype, device, generator)
        self.w_up = weight((d, sf), d ** -0.5, dtype, device, generator)
        self.w_down = weight((sf, d), sf ** -0.5, dtype, device, generator)


class MoE(nn.Module):
    """The routed experts of ``moe``; calling it runs ``moe`` (so a forward
    hook sees ``(y, metrics)``)."""

    def __init__(self, cfg, dtype, device, generator):
        super().__init__()
        self.cfg = cfg
        d, e = cfg.d_model, cfg.n_experts
        ff = cfg.moe_d_ff or cfg.d_ff
        std_in, std_out = d ** -0.5, ff ** -0.5
        self.router = weight((d, e), std_in, torch.float32, device,
                             generator)
        self.wg = weight((e, d, ff), std_in, dtype, device, generator)
        self.wu = weight((e, d, ff), std_in, dtype, device, generator)
        self.wd = weight((e, ff, d), std_out, dtype, device, generator)
        if cfg.n_shared_experts:
            self.shared = _Shared(d, cfg.n_shared_experts * ff, dtype,
                                  device, generator)

    def forward(self, x):
        return moe(x, self, self.cfg)


def top_k(x, k):
    """``jax.lax.top_k`` along the last axis: the k largest, equal values
    in ascending index order (a stable descending sort; ``torch.topk``
    promises no order among ties)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _routing(x2, p, cfg):
    """x2: (T, d) -> (top-k weights (T, K) in x2's dtype, top-k experts
    (T, K), the Switch load-balance loss), in float32 as in JAX."""
    logits = x2.float() @ p.router.float()
    probs = torch.softmax(logits, dim=-1)                     # (T, E)
    w, idx = top_k(probs, cfg.moe_top_k)                      # (T, K)
    w = w / torch.clamp_min(w.sum(dim=-1, keepdim=True), 1e-9)
    e = cfg.n_experts
    me = probs.mean(dim=0)                                    # (E,)
    ce = ctx.local_map(lambda i: torch.zeros(
        e, dtype=torch.float32, device=i.device).index_add_(
        0, i.reshape(-1), torch.full((i.numel(),), 1.0 / i.numel(),
                                     device=i.device)), (idx, {}))
    aux = e * torch.sum(me * ce)
    return w.to(x2.dtype), idx, aux


def _expert_ffn(xe, p):
    """xe: (E, C, d) -> (E, C, d) through each expert's SwiGLU."""
    h = silu(torch.bmm(xe, cast(p.wg, xe)))
    h.mul_(torch.bmm(xe, cast(p.wu, xe)))
    return torch.bmm(h, cast(p.wd, xe))


def _grouped_expert_ffn(buckets, p):
    """buckets: (G, E, cap, d) -> (G, E, cap, d) through each expert's
    SwiGLU.  Plain tensors go through one batched product a weight over
    (E, G * cap, d); DTensors, whose sharded G cannot merge with cap, take
    JAX's einsums ("gecd,edf->gecf")."""
    g, e, cap, d = buckets.shape
    if not ctx.is_dtensor(buckets):
        xe = buckets.permute(1, 0, 2, 3).reshape(e, g * cap, d)
        return _expert_ffn(xe, p).view(e, g, cap, d).permute(1, 0, 2, 3)
    h = silu(torch.einsum("gecd,edf->gecf", buckets, cast(p.wg, buckets)))
    h = h * torch.einsum("gecd,edf->gecf", buckets, cast(p.wu, buckets))
    return torch.einsum("gecf,efd->gecd", h, cast(p.wd, buckets))


def _dispatch(xg, idxg, e, cap):
    """Each group's scatter into its buckets: xg (G, Tl, d), idxg (G, Tl,
    K) -> (buckets (G, E, cap, d), keep (G, Tl*K), the bucket row of each
    kept choice, 0 for a dropped one (G, Tl*K))."""
    g, tl, d = xg.shape
    k = idxg.shape[2]
    flat_e = idxg.reshape(g, tl * k)                          # (G, Tl*K)
    onehot = F.one_hot(flat_e, e)
    pos = (torch.cumsum(onehot, dim=1) - 1).gather(
        2, flat_e[..., None])[..., 0]
    keep = pos < cap
    slot = flat_e * cap + pos
    # dropped choices write each group's spare last row, which is cut off
    buckets = xg.new_zeros((g, e * cap + 1, d))
    rows = torch.arange(g, device=xg.device)[:, None].expand(g, tl * k)
    buckets[rows, torch.where(keep, slot, e * cap)] = xg[:, :, None].expand(
        g, tl, k, d).reshape(g, tl * k, d)
    return (buckets[:, :-1].view(g, e, cap, d), keep,
            torch.where(keep, slot, 0))


def _combine(ye, keep, src, w):
    """Each group's gather back and weighted sum: ye (G, E*cap, d), keep
    and src (G, Tl*K), the routing weights w (G, Tl, K) -> (G, Tl, d); a
    dropped choice reads row 0 times 0."""
    g, tl, k = w.shape
    rows = torch.arange(g, device=ye.device)[:, None].expand(src.shape)
    yk = ye[rows, src] * keep[..., None].to(ye.dtype)
    return (yk.view(g, tl, k, -1) * w[..., None]).sum(dim=2)


def moe(x, p, cfg):
    """x: (B, S, d) -> (y (B, S, d), metrics): ``router_aux``,
    ``dropped_fraction`` (float32 0-dim) and ``expert_idx`` (B, S, K)."""
    b, s, d = x.shape
    x2 = x.reshape(b * s, d)
    w, idx, aux = _routing(x2, p, cfg)
    t, k = idx.shape
    e = cfg.n_experts
    if cfg.moe_dispatch == "dense":
        ye = _expert_ffn(x2[None].expand(e, t, d), p)         # (E, T, d)
        onehot = F.one_hot(idx, e).to(x.dtype)                # (T, K, E)
        comb = (onehot * w[..., None]).sum(dim=1)             # (T, E)
        y2 = torch.einsum("te,etd->td", comb, ye)
        dropped = torch.zeros((), dtype=torch.float32, device=x.device)
    else:
        # dispatch LOCALLY within each data-parallel group, as JAX does
        dpa = ctx.dp_axes()
        sizes = ctx.axis_sizes()
        groups = 1
        for a in dpa:
            groups *= sizes.get(a, 1)
        if groups <= 1 or t % groups != 0:
            groups = 1
        tl = t // groups                                      # local tokens
        # JAX's own expression for the capacity, Python's round included
        cap = int(max(1, round(cfg.capacity_factor * tl * k / e)))
        cap = min(cap, tl)
        buckets, keep, src = ctx.local_map(
            lambda xg, ig: _dispatch(xg, ig, e, cap),
            (x2.reshape(groups, tl, d), {0: dpa}),
            (idx.reshape(groups, tl, k), {0: dpa}))
        buckets = ctx.constrain(buckets, {0: dpa, 1: "model"})
        dropped = 1.0 - keep.reshape(-1).float().mean()
        ye = _grouped_expert_ffn(buckets, p).reshape(groups, e * cap, d)
        # expert outputs back to their groups before the combine gather
        ye = ctx.constrain(ye, {0: dpa})
        y2 = ctx.local_map(_combine, (ye, {0: dpa}), (keep, {0: dpa}),
                           (src, {0: dpa}),
                           (w.reshape(groups, tl, k), {0: dpa})).reshape(t, d)
    if cfg.n_shared_experts:
        sp = p.shared
        hs = silu(x2 @ cast(sp.w_gate, x2)) * (x2 @ cast(sp.w_up, x2))
        y2 = y2 + hs @ cast(sp.w_down, x2)
    metrics = {"router_aux": aux, "dropped_fraction": dropped,
               "expert_idx": idx.reshape(b, s, k)}
    return y2.reshape(b, s, d), metrics

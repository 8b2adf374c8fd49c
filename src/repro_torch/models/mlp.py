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
  * "scatter" -- capacity-bucketed dispatch (the configs' default): each
                 token's k choices scatter into (E, capacity, d) buckets at
                 their token-major, k-minor cumulative position, the experts
                 run as one batched product, and the outputs gather back
                 with the routing weights.  Choices past an expert's
                 capacity are dropped, as in JAX, and counted in
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

The JAX package dispatches within data-parallel groups
(``repro.dist.ctx.dp_axes()``), which outside a JAX mesh is one group.  The
port runs in one process with no data-parallel mesh, so it always uses one
group.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

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
    ce = torch.zeros(e, dtype=torch.float32, device=x2.device).index_add_(
        0, idx.reshape(-1), torch.full((idx.numel(),), 1.0 / idx.numel(),
                                       device=x2.device))
    aux = e * torch.sum(me * ce)
    return w.to(x2.dtype), idx, aux


def _expert_ffn(xe, p):
    """xe: (E, C, d) -> (E, C, d) through each expert's SwiGLU."""
    h = silu(torch.bmm(xe, cast(p.wg, xe)))
    h.mul_(torch.bmm(xe, cast(p.wu, xe)))
    return torch.bmm(h, cast(p.wd, xe))


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
        # JAX's own expression for the capacity, Python's round included
        cap = int(max(1, round(cfg.capacity_factor * t * k / e)))
        cap = min(cap, t)
        flat_e = idx.reshape(-1)                              # (T*K,)
        onehot = F.one_hot(flat_e, e)
        pos = (torch.cumsum(onehot, dim=0) - 1).gather(
            1, flat_e[:, None])[:, 0]
        keep = pos < cap
        slot = flat_e * cap + pos
        # dropped choices write the spare last row, which is cut off
        buckets = x2.new_zeros((e * cap + 1, d))
        buckets[torch.where(keep, slot, e * cap)] = x2[:, None].expand(
            t, k, d).reshape(t * k, d)
        dropped = 1.0 - keep.float().mean()
        ye = _expert_ffn(buckets[:-1].view(e, cap, d), p).view(e * cap, d)
        yk = ye[torch.where(keep, slot, 0)] * keep[:, None].to(x.dtype)
        y2 = (yk.view(t, k, d) * w[..., None]).sum(dim=1)
    if cfg.n_shared_experts:
        sp = p.shared
        hs = silu(x2 @ cast(sp.w_gate, x2)) * (x2 @ cast(sp.w_up, x2))
        y2 = y2 + hs @ cast(sp.w_down, x2)
    metrics = {"router_aux": aux, "dropped_fraction": dropped,
               "expert_idx": idx.reshape(b, s, k)}
    return y2.reshape(b, s, d), metrics

"""Mamba-1, the state-space mixer of Jamba: the port of the Mamba half of
the JAX package's ``repro/models/ssm.py`` (mLSTM and sLSTM are not ported
yet, ROADMAP Queue 1).

``Mamba`` holds the JAX keys ``in_proj`` (d, 2 di), ``conv_w`` (dc, di),
``conv_b``, ``x_proj`` (di, dt_rank + 2 ds), ``dt_proj`` (dt_rank, di),
``dt_bias``, ``A_log`` (di, ds), ``D`` and ``out_proj`` (di, d).  Each is
stored as JAX reads it: ``A_log`` float32, every other one in the compute
dtype.

``mamba_train`` runs the selective scan in chunks of ``cfg.ssm_chunk``
tokens carrying the float32 state from chunk to chunk, as JAX's
``lax.scan`` does, so its live memory is O(B * chunk * di * ds).  Inside a
chunk a Hillis-Steele doubling (log2(chunk) steps, 7 at 128) takes the
place of JAX's ``associative_scan``: the same recurrence, another
association order, so the float32 results agree to rounding, not to the
bit.  The decode state is (``conv`` (B, dc - 1, di) in the compute dtype,
``h`` (B, di, ds) float32); ``mamba_decode`` returns new tensors and never
writes the state it is given.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.models.layers import fill, param, weight
from repro_torch.models.mlp import silu


def mamba_dims(cfg):
    di = cfg.ssm_expand * cfg.d_model
    dt_rank = cfg.ssm_dt_rank or -(-cfg.d_model // 16)
    return di, dt_rank


class Mamba(nn.Module):
    """The Mamba mixer's parameters, with JAX's init shapes and scales."""

    def __init__(self, cfg, dtype, device, generator):
        super().__init__()
        d = cfg.d_model
        di, dt_rank = mamba_dims(cfg)
        ds, dc = cfg.ssm_d_state, cfg.ssm_d_conv
        self.in_proj = weight((d, 2 * di), d ** -0.5, dtype, device,
                              generator)
        self.conv_w = weight((dc, di), 0.1, dtype, device, generator)
        self.conv_b = fill((di,), 0.0, dtype, device)
        self.x_proj = weight((di, dt_rank + 2 * ds), di ** -0.5, dtype,
                             device, generator)
        self.dt_proj = weight((dt_rank, di), dt_rank ** -0.5, dtype, device,
                              generator)
        self.dt_bias = fill((di,), -4.6, dtype, device)   # softplus ~ 0.01
        a_log = np.log(np.arange(1, ds + 1, dtype=np.float32))
        self.A_log = param(torch.from_numpy(np.broadcast_to(
            a_log, (di, ds)).copy()).to(device))
        self.D = fill((di,), 1.0, dtype, device)
        self.out_proj = weight((di, d), di ** -0.5, dtype, device, generator)


def softplus(x):
    """``jax.nn.softplus``, which is ``logaddexp(x, 0)``, op for op in x's
    dtype: max(x, 0) + log1p(exp(-|x|)), rounded after every op.
    ``F.softplus`` rounds once and switches to x above a threshold of 20,
    so in bfloat16 it differs from JAX."""
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    out = torch.maximum(x, zero) + torch.log1p(torch.exp(-torch.abs(x)))
    return torch.where(torch.isnan(x), x + zero, out)


def causal_conv(x, w, b, state=None):
    """Depthwise causal conv.  x: (B, T, di); w: (dc, di); state: (B, dc -
    1, di), the carried tail for decode.  Returns (y, new state).  The taps
    are summed in JAX's order in x's dtype, rounded after each product and
    add, then ``+ b`` (``F.conv1d`` accumulates in float32 and rounds
    once, which differs in bfloat16)."""
    dc, t = w.shape[0], x.shape[1]
    if state is None:
        state = x.new_zeros((x.shape[0], dc - 1, x.shape[2]))
    xp = torch.cat([state, x], dim=1)
    y = xp[:, 0:t] * w[0]
    for i in range(1, dc):
        y = y + xp[:, i:i + t] * w[i]
    return y + b, xp[:, -(dc - 1):]


def _scan_chunk(a, bx, h0):
    """h_t = a_t * h_{t-1} + bx_t over one chunk.  a, bx: (B, T, di, ds)
    float32; h0: (B, di, ds).  Returns every h (B, T, di, ds).  After the
    step of offset o, position t holds the composition of positions
    t - 2o + 1 .. t (JAX's ``combine``: (a_l a_r, a_r b_l + b_r))."""
    t, off = a.shape[1], 1
    while off < t:
        nb = bx.clone()
        nb[:, off:] += a[:, off:] * bx[:, :-off]
        na = a.clone()
        na[:, off:] *= a[:, :-off]
        a, bx, off = na, nb, 2 * off
    return bx + a * h0[:, None]


def _dt(proj, p, dt_rank):
    return softplus(proj[..., :dt_rank] @ p.dt_proj + p.dt_bias)


def scan_inputs(x, p, cfg):
    """x: (B, S, d) -> (xi_raw, z, xi, dt, bmat, cmat): the input
    projection's halves (B, S, di), the conv's activated output xi, the
    step sizes dt (B, S, di) and the input and output matrices (B, S, ds),
    all in x's dtype."""
    di, dt_rank = mamba_dims(cfg)
    ds = cfg.ssm_d_state
    xz = x @ p.in_proj
    xi_raw, z = xz[..., :di], xz[..., di:]
    xi = silu(causal_conv(xi_raw, p.conv_w, p.conv_b)[0])
    proj = xi @ p.x_proj
    return (xi_raw, z, xi, _dt(proj, p, dt_rank),
            proj[..., dt_rank:dt_rank + ds], proj[..., dt_rank + ds:])


def selective_scan(xi, dt, bmat, cmat, a_log, chunk, out_dtype=None):
    """The chunked selective scan from a zero state: y (B, S, di) in
    ``out_dtype`` (xi's by default) and the final h (B, di, ds) float32.
    Each chunk of ``chunk`` tokens runs ``_scan_chunk`` in float32 and
    hands its last h to the next."""
    b, s, di = xi.shape
    a = -torch.exp(a_log.float())                             # (di, ds)
    h = torch.zeros((b, di, a.shape[1]), dtype=torch.float32,
                    device=xi.device)
    y = torch.empty((b, s, di), dtype=out_dtype or xi.dtype,
                    device=xi.device)
    for c0 in range(0, s, chunk):
        sl = slice(c0, c0 + chunk)
        dt32 = dt[:, sl].float()
        abar = torch.exp(dt32[..., None] * a)                 # (B,T,di,ds)
        bx = (dt32 * xi[:, sl].float())[..., None] \
            * bmat[:, sl].float()[:, :, None, :]
        h_all = _scan_chunk(abar, bx, h)
        del abar, bx
        y[:, sl] = torch.einsum("btds,bts->btd", h_all,
                                cmat[:, sl].float()).to(y.dtype)
        h = h_all[:, -1].clone()
        del h_all
    return y, h


def selective_scan_steps(xi, dt, bmat, cmat, a_log):
    """The plain per-token float32 recurrence that ``selective_scan``
    computes: h_t = exp(dt_t a) h_{t-1} + dt_t x_t B_t, y_t = h_t C_t.
    Returns (y (B, S, di) float32, the final h)."""
    b, s, di = xi.shape
    a = -torch.exp(a_log.float())
    h = torch.zeros((b, di, a.shape[1]), dtype=torch.float32,
                    device=xi.device)
    y = torch.empty((b, s, di), dtype=torch.float32, device=xi.device)
    for t in range(s):
        dt32 = dt[:, t].float()
        h = torch.exp(dt32[..., None] * a) * h \
            + (dt32 * xi[:, t].float())[..., None] \
            * bmat[:, t].float()[:, None, :]
        y[:, t] = torch.einsum("bds,bs->bd", h, cmat[:, t].float())
    return y, h


def mamba_train(x, p, cfg, return_state=False):
    """x: (B, S, d) -> (B, S, d) [, the decode state after the sequence:
    (conv (B, dc - 1, di), h (B, di, ds) float32)].  S must be a multiple
    of ``cfg.ssm_chunk`` when it is longer."""
    s = x.shape[1]
    chunk = min(cfg.ssm_chunk, s)
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of ssm_chunk "
                         f"{chunk}")
    xi_raw, z, xi, dt, bmat, cmat = scan_inputs(x, p, cfg)
    y, h = selective_scan(xi, dt, bmat, cmat, p.A_log, chunk)
    y = y + xi * p.D
    y = y * silu(z)
    out = y @ p.out_proj
    if return_state:
        # the conv state carries the last dc - 1 pre-conv activations (a
        # copy: a view would keep all of xz alive)
        return out, (xi_raw[:, -(cfg.ssm_d_conv - 1):].clone(), h)
    return out


def mamba_init_state(cfg, batch, dtype, device):
    di, _ = mamba_dims(cfg)
    return (torch.zeros((batch, cfg.ssm_d_conv - 1, di), dtype=dtype,
                        device=device),
            torch.zeros((batch, di, cfg.ssm_d_state), dtype=torch.float32,
                        device=device))


def mamba_decode(x_tok, p, cfg, conv, h):
    """x_tok: (B, d); the state (conv, h) -> (out (B, d), (new conv, new
    h)): an O(1) update into new tensors."""
    di, dt_rank = mamba_dims(cfg)
    ds = cfg.ssm_d_state
    xz = x_tok[:, None, :] @ p.in_proj
    xi, z = xz[..., :di], xz[..., di:]
    xi, conv = causal_conv(xi, p.conv_w, p.conv_b, conv)
    xi = silu(xi)[:, 0]                                       # (B, di)
    proj = xi @ p.x_proj
    dt32 = _dt(proj, p, dt_rank).float()
    bvec = proj[..., dt_rank:dt_rank + ds].float()
    cvec = proj[..., dt_rank + ds:].float()
    a = -torch.exp(p.A_log.float())
    abar = torch.exp(dt32[..., None] * a[None])               # (B, di, ds)
    bx = (dt32 * xi.float())[..., None] * bvec[:, None, :]
    h = abar * h + bx
    y = torch.einsum("bds,bs->bd", h, cvec).to(x_tok.dtype)
    y = y + xi * p.D
    y = y * silu(z[:, 0])
    return y @ p.out_proj, (conv, h)

"""The recurrent mixers: Mamba-1 (Jamba), and mLSTM and sLSTM (xLSTM), the
port of the JAX package's ``repro/models/ssm.py``.

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
writes the state it is given.  Under autograd each chunk's scan runs in
``torch.utils.checkpoint``: the doubling keeps 2 log2(chunk) tensors of
(B, chunk, di, ds) float32 alive for its backward (0.9 GB a chunk at
Jamba's width), so only the carried h (B, di, ds) is kept between chunks
and one chunk's scan is recomputed at a time in the backward pass.

``MLSTM`` (matrix memory) holds ``up`` (d, 2 di), ``wq`` / ``wk`` / ``wv``
(di, h, dh), ``wi`` / ``wf`` (di, h), ``down`` (di, d) in the compute
dtype and ``bi``, ``bf`` (h,) and the norm scale ``ln`` (di,) float32.
``SLSTM`` (scalar memory) holds ``w`` (d, 4, h, dh), ``up`` (d, 2 ff) and
``down`` (ff, d) in the compute dtype and the recurrent ``r`` (4, h, dh,
dh) and ``b`` (4, h, dh) float32, as JAX reads them.  Both gate
exponentially with a float32 stabilizer m that starts at -1e30; their
decode states are dicts of float32 tensors under JAX's names (mLSTM:
``C`` (B, h, dh, dh), ``n`` (B, h, dh), ``m`` (B, h); sLSTM: ``c``,
``n``, ``h``, ``m`` (B, h, dh)), and the decode steps return new ones.
``mlstm_train`` takes the chunkwise-parallel form (``mlstm_chunked``)
exactly where JAX does (``cfg.xlstm_chunk`` set, S a multiple of it and
longer), else the per-token recurrence (``mlstm_steps``); the sLSTM runs
token by token.  The float32 gates are PyTorch's fused ``F.logsigmoid``
and ``torch.sigmoid``, within 2.3e-7 relative of ``jax.nn``'s (measured;
XLA expands them into several ops): the sLSTM runs them once a token a
layer, so its op count sets the prefill's time.

Training reads every matrix through ``layers.cast`` (a no-op for the
serving model, whose matrices are stored in the compute dtype; a cast of
the float32 master under training), as JAX writes ``p[...].astype(dt)``;
``A_log``, the xLSTM gate biases and norm scale, and the sLSTM's ``r``
and ``b`` are read in float32, as there.  The per-token loops collect
their outputs in a list and stack them once: a slice write into a
preallocated tensor is, under autograd, a node whose backward copies the
whole gradient, once a token.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.dist import ctx
from repro_torch.models.layers import cast, fill, param, rms_norm, weight
from repro_torch.models.mlp import gelu_tanh, silu


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
    return softplus(proj[..., :dt_rank] @ cast(p.dt_proj, proj)
                    + cast(p.dt_bias, proj))


def scan_inputs(x, p, cfg):
    """x: (B, S, d) -> (xi_raw, z, xi, dt, bmat, cmat): the input
    projection's halves (B, S, di), the conv's activated output xi, the
    step sizes dt (B, S, di) and the input and output matrices (B, S, ds),
    all in x's dtype."""
    di, dt_rank = mamba_dims(cfg)
    ds = cfg.ssm_d_state
    xz = x @ cast(p.in_proj, x)
    xi_raw, z = xz[..., :di], xz[..., di:]
    xi = silu(causal_conv(xi_raw, cast(p.conv_w, x), cast(p.conv_b, x))[0])
    proj = xi @ cast(p.x_proj, x)
    return (xi_raw, z, xi, _dt(proj, p, dt_rank),
            proj[..., dt_rank:dt_rank + ds], proj[..., dt_rank + ds:])


def _chunk_scan(h, a, dt, xi, bmat, cmat):
    """One chunk of the selective scan from h (B, di, ds): y (B, T, di)
    float32 and the chunk's last h."""
    dt32 = dt.float()
    abar = torch.exp(dt32[..., None] * a)                     # (B,T,di,ds)
    bx = (dt32 * xi.float())[..., None] * bmat.float()[:, :, None, :]
    h_all = _scan_chunk(abar, bx, h)
    del abar, bx
    y = torch.einsum("btds,bts->btd", h_all, cmat.float())
    return y, h_all[:, -1].clone()


def selective_scan(xi, dt, bmat, cmat, a_log, chunk, out_dtype=None):
    """The chunked selective scan from a zero state: y (B, S, di) in
    ``out_dtype`` (xi's by default) and the final h (B, di, ds) float32.
    Each chunk of ``chunk`` tokens runs ``_scan_chunk`` in float32 and
    hands its last h to the next; under autograd each chunk is
    checkpointed (see the module docstring)."""
    b, s, di = xi.shape
    a = -torch.exp(a_log.float())                             # (di, ds)
    h = torch.zeros((b, di, a.shape[1]), dtype=torch.float32,
                    device=xi.device)
    ys = []
    for c0 in range(0, s, chunk):
        sl = slice(c0, c0 + chunk)
        args = (h, a, dt[:, sl], xi[:, sl], bmat[:, sl], cmat[:, sl])
        if torch.is_grad_enabled():
            y, h = checkpoint(_chunk_scan, *args, use_reentrant=False)
        else:
            y, h = _chunk_scan(*args)
        ys.append(y.to(out_dtype or xi.dtype))
    return torch.cat(ys, dim=1), h


def selective_scan_steps(xi, dt, bmat, cmat, a_log):
    """The plain per-token float32 recurrence that ``selective_scan``
    computes: h_t = exp(dt_t a) h_{t-1} + dt_t x_t B_t, y_t = h_t C_t.
    Returns (y (B, S, di) float32, the final h)."""
    b, s, di = xi.shape
    a = -torch.exp(a_log.float())
    h = torch.zeros((b, di, a.shape[1]), dtype=torch.float32,
                    device=xi.device)
    ys = []
    for t in range(s):
        dt32 = dt[:, t].float()
        h = torch.exp(dt32[..., None] * a) * h \
            + (dt32 * xi[:, t].float())[..., None] \
            * bmat[:, t].float()[:, None, :]
        ys.append(torch.einsum("bds,bs->bd", h, cmat[:, t].float()))
    return torch.stack(ys, dim=1), h


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
    y = y + xi * cast(p.D, xi)
    y = y * silu(z)
    out = y @ cast(p.out_proj, y)
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
    xz = x_tok[:, None, :] @ cast(p.in_proj, x_tok)
    xi, z = xz[..., :di], xz[..., di:]
    xi, conv = causal_conv(xi, cast(p.conv_w, xi), cast(p.conv_b, xi), conv)
    xi = silu(xi)[:, 0]                                       # (B, di)
    proj = xi @ cast(p.x_proj, xi)
    dt32 = _dt(proj, p, dt_rank).float()
    bvec = proj[..., dt_rank:dt_rank + ds].float()
    cvec = proj[..., dt_rank + ds:].float()
    a = -torch.exp(p.A_log.float())
    abar = torch.exp(dt32[..., None] * a[None])               # (B, di, ds)
    bx = (dt32 * xi.float())[..., None] * bvec[:, None, :]
    h = abar * h + bx
    y = torch.einsum("bds,bs->bd", h, cvec).to(x_tok.dtype)
    y = y + xi * cast(p.D, xi)
    y = y * silu(z[:, 0])
    return y @ cast(p.out_proj, y), (conv, h)


# ---------------------------------------------------------------------------
# xLSTM: mLSTM (matrix memory) and sLSTM (scalar memory)
# ---------------------------------------------------------------------------

def _xlstm_dims(cfg):
    di = cfg.ssm_expand * cfg.d_model
    return di, cfg.xlstm_heads, di // cfg.xlstm_heads


class MLSTM(nn.Module):
    """The mLSTM mixer's parameters, with JAX's init shapes and scales."""

    def __init__(self, cfg, dtype, device, generator):
        super().__init__()
        d = cfg.d_model
        di, h, dh = _xlstm_dims(cfg)
        std, f32 = di ** -0.5, torch.float32
        self.up = weight((d, 2 * di), d ** -0.5, dtype, device, generator)
        self.wq = weight((di, h, dh), std, dtype, device, generator)
        self.wk = weight((di, h, dh), std, dtype, device, generator)
        self.wv = weight((di, h, dh), std, dtype, device, generator)
        self.wi = weight((di, h), std, dtype, device, generator)
        self.wf = weight((di, h), std, dtype, device, generator)
        self.bi = fill((h,), 0.0, f32, device)
        self.bf = fill((h,), 3.0, f32, device)        # forget-dominant init
        self.ln = fill((di,), 0.0, f32, device)
        self.down = weight((di, d), di ** -0.5, dtype, device, generator)


class _LogSigmoid(torch.autograd.Function):
    """``F.logsigmoid`` of a DTensor, whose backward op
    (``log_sigmoid_backward``) has no DTensor sharding strategy: the
    gradient is written out, g * sigmoid(-x)."""

    @staticmethod
    def forward(c, x):
        c.save_for_backward(x)
        return F.logsigmoid(x)

    @staticmethod
    def backward(c, g):
        (x,) = c.saved_tensors
        return g * torch.sigmoid(-x)


def _logsigmoid(x):
    """``F.logsigmoid``; a DTensor's through ``_LogSigmoid``."""
    return _LogSigmoid.apply(x) if ctx.is_dtensor(x) else F.logsigmoid(x)


def _on_batch_shards(fn, x):
    """``fn(x)`` (a scan along dim 1); under a device mesh on each
    device's batch shard: DTensor has no strategy for ``cummax``, nor, in
    some torch versions, for the ``flip`` of ``cumsum``'s backward."""
    return ctx.local_map(fn, (x, {0: ctx.dp_axes()}))


def mlstm_init_state(cfg, batch, device):
    _, h, dh = _xlstm_dims(cfg)
    f32 = torch.float32
    return {"C": torch.zeros((batch, h, dh, dh), dtype=f32, device=device),
            "n": torch.zeros((batch, h, dh), dtype=f32, device=device),
            "m": torch.full((batch, h), -1e30, dtype=f32, device=device)}


def mlstm_step(state, q, k, v, i_pre, f_pre):
    """One stabilized mLSTM step (exponential gating, Beck et al. 2024):
    q, k, v (B, h, dh) and the gate inputs (B, h), all float32 -> (the new
    state, h (B, h, dh))."""
    C, n = state["C"], state["n"]
    fm = _logsigmoid(f_pre) + state["m"]
    m_new = torch.maximum(fm, i_pre)
    i_g = torch.exp(i_pre - m_new)
    f_g = torch.exp(fm - m_new)
    C_new = f_g[..., None, None] * C + i_g[..., None, None] \
        * (v[..., :, None] * k[..., None, :])                 # (B, h, dh, dh)
    n_new = f_g[..., None] * n + i_g[..., None] * k
    num = torch.matmul(C_new, q[..., None])[..., 0]
    den = torch.maximum(torch.abs((n_new * q).sum(dim=-1)),
                        torch.exp(-m_new))
    return {"C": C_new, "n": n_new, "m": m_new}, num / den[..., None]


def mlstm_inputs(xi, p, cfg):
    """xi (B, T, di) -> q, k (scaled by dh^-0.5), v (B, T, h, dh) and the
    input and forget gate inputs (B, T, h), float32; the projections run
    in xi's dtype."""
    b, t, di = xi.shape
    _, h, dh = _xlstm_dims(cfg)

    def heads(w):                          # einsum("btd,dhk->bthk")
        return (xi @ cast(w, xi).reshape(di, h * dh)).reshape(
            b, t, h, dh).float()

    q, k, v = heads(p.wq), heads(p.wk) * dh ** -0.5, heads(p.wv)
    i_pre = (xi @ cast(p.wi, xi)).float() + p.bi
    f_pre = (xi @ cast(p.wf, xi)).float() + p.bf
    return q, k, v, i_pre, f_pre


def mlstm_steps(q, k, v, i_pre, f_pre, state):
    """The per-token recurrence from ``state`` over q, k, v (B, S, h, dh)
    and the gate inputs (B, S, h): (h (B, S, h, dh) float32, the final
    state)."""
    hs = []
    for t in range(q.shape[1]):
        state, h_t = mlstm_step(state, q[:, t], k[:, t], v[:, t],
                                i_pre[:, t], f_pre[:, t])
        hs.append(h_t)
    return torch.stack(hs, dim=1), state


def mlstm_chunked(q, k, v, i_pre, f_pre, state, chunk):
    """The chunkwise-parallel mLSTM from ``state``: the same recurrence as
    ``mlstm_steps`` with C updated once a chunk of ``chunk`` tokens and the
    within-chunk part an (L, L)-masked attention-like product, in the JAX
    package's ``_mlstm_chunked`` arithmetic.  Within a chunk, with F_t the
    cumulative log forget gate:

        m_t = F_t + cummax(max(m0, i_j - F_j))
        C_t = e^{m0+F_t-m_t} C_0 + sum_{j<=t} e^{i_j+F_t-F_j-m_t} v_j k_j
        h_t = C_t q_t / max(|n_t q_t|, e^{-m_t})

    Returns (h (B, S, h, dh) float32, the final state)."""
    b, s, h, dh = q.shape
    C0, n0, m0 = state["C"], state["n"], state["m"]
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=q.device))[None, :, :, None]
    hs = []
    for c0 in range(0, s, chunk):
        sl = slice(c0, c0 + chunk)
        qt, kt, vt, it = q[:, sl], k[:, sl], v[:, sl], i_pre[:, sl]
        Fc = _on_batch_shards(lambda t: torch.cumsum(t, dim=1),
                              _logsigmoid(f_pre[:, sl]))      # (B, L, h)
        m = Fc + torch.maximum(m0[:, None], _on_batch_shards(
            lambda t: torch.cummax(t, dim=1).values, it - Fc))
        w0 = torch.exp(m0[:, None] + Fc - m)                  # (B, L, h)
        # log-weights (B, L_t, L_j, h) of token j in output t
        D = it[:, None] + Fc[:, :, None] - Fc[:, None] - m[:, :, None]
        expD = torch.exp(torch.where(tri, D, -torch.inf))
        A = torch.einsum("bthd,bjhd->btjh", qt, kt) * expD
        h_num = (w0[..., None] * torch.einsum("bthd,bhvd->bthv", qt, C0)
                 + torch.einsum("btjh,bjhv->bthv", A, vt))
        n_t = (w0[..., None] * n0[:, None]
               + torch.einsum("btjh,bjhd->bthd", expD, kt))
        den = torch.maximum(torch.abs((n_t * qt).sum(dim=-1)),
                            torch.exp(-m))
        hs.append(h_num / den[..., None])
        # the chunk-end state (t = L - 1)
        m_new = m[:, -1]
        wC = torch.exp(m0 + Fc[:, -1] - m_new)                # (B, h)
        wj = torch.exp(it + Fc[:, -1:] - Fc - m_new[:, None])  # (B, L, h)
        C0 = wC[..., None, None] * C0 + torch.einsum(
            "bjhv,bjhd->bhvd", wj[..., None] * vt, kt)
        n0 = wC[..., None] * n0 + torch.einsum("bjh,bjhd->bhd", wj, kt)
        m0 = m_new
    return torch.cat(hs, dim=1), {"C": C0, "n": n0, "m": m0}


def mlstm_train(x, p, cfg, return_state=False):
    """x: (B, S, d) -> (B, S, d) [, the decode state after the sequence]:
    the chunkwise-parallel form where JAX takes it, else the per-token
    recurrence."""
    b, s, _ = x.shape
    di = cfg.ssm_expand * cfg.d_model
    xz = x @ cast(p.up, x)
    xi, z = xz[..., :di], xz[..., di:]
    q, k, v, i_pre, f_pre = mlstm_inputs(xi, p, cfg)
    state = mlstm_init_state(cfg, b, x.device)
    chunk = cfg.xlstm_chunk
    if chunk and s % chunk == 0 and s > chunk:
        hs, state = mlstm_chunked(q, k, v, i_pre, f_pre, state, chunk)
    else:
        hs, state = mlstm_steps(q, k, v, i_pre, f_pre, state)
    hs = rms_norm(hs.reshape(b, s, di).to(x.dtype), p.ln, cfg.norm_eps)
    out = (hs * silu(z)) @ cast(p.down, hs)
    return (out, state) if return_state else out


def mlstm_decode(x_tok, p, cfg, state):
    """x_tok: (B, d) -> (out (B, d), the new state)."""
    b = x_tok.shape[0]
    di = cfg.ssm_expand * cfg.d_model
    xz = x_tok[:, None, :] @ cast(p.up, x_tok)
    xi, z = xz[..., :di], xz[:, 0, di:]
    q, k, v, i_pre, f_pre = mlstm_inputs(xi, p, cfg)
    state, h = mlstm_step(state, q[:, 0], k[:, 0], v[:, 0], i_pre[:, 0],
                          f_pre[:, 0])
    hs = rms_norm(h.reshape(b, di).to(x_tok.dtype), p.ln, cfg.norm_eps)
    return (hs * silu(z)) @ cast(p.down, hs), state


class SLSTM(nn.Module):
    """The sLSTM mixer's parameters, with JAX's init shapes and scales."""

    def __init__(self, cfg, dtype, device, generator):
        super().__init__()
        d, h = cfg.d_model, cfg.xlstm_heads
        dh = d // h
        ff = max(1, (4 * d) // 3)
        f32 = torch.float32
        self.w = weight((d, 4, h, dh), d ** -0.5, dtype, device, generator)
        self.r = weight((4, h, dh, dh), dh ** -0.5, f32, device, generator)
        self.b = fill((4, h, dh), 0.0, f32, device)
        self.up = weight((d, 2 * ff), d ** -0.5, dtype, device, generator)
        self.down = weight((ff, d), ff ** -0.5, dtype, device, generator)


def slstm_init_state(cfg, batch, device):
    h = cfg.xlstm_heads
    dh = cfg.d_model // h
    f32 = torch.float32
    z = torch.zeros((batch, h, dh), dtype=f32, device=device)
    return {"c": z, "n": z, "h": z,
            "m": torch.full((batch, h, dh), -1e30, dtype=f32, device=device)}


def slstm_step(p, state, wx):
    """One sLSTM step: wx (B, 4, h, dh), the input's contributions to the
    i, f, z and o gates -> (the new state, h (B, h, dh) float32)."""
    c, n = state["c"], state["n"]
    # einsum("ghkl,bhl->bghk", r, h): (4, h, dh, dh) @ (B, 1, h, dh, 1)
    rec = torch.matmul(p.r, state["h"][:, None, :, :, None])[..., 0]
    pre = wx.float() + rec + p.b
    i_pre, f_pre, z_pre, o_pre = pre.unbind(1)
    fm = _logsigmoid(f_pre) + state["m"]
    m_new = torch.maximum(fm, i_pre)
    i_g = torch.exp(i_pre - m_new)
    f_g = torch.exp(fm - m_new)
    c_new = f_g * c + i_g * torch.tanh(z_pre)
    n_new = f_g * n + i_g
    h_new = torch.sigmoid(o_pre) * c_new / torch.clamp_min(n_new, 1e-6)
    return {"c": c_new, "n": n_new, "h": h_new, "m": m_new}, h_new


def _slstm_wx(x, p):
    """einsum("...d,dghk->...ghk") in x's dtype."""
    d, g, h, dh = p.w.shape
    return (x @ cast(p.w, x).reshape(d, g * h * dh)).reshape(
        *x.shape[:-1], g, h, dh)


def _slstm_out(hs, p):
    """The post up/down projection (factor 4/3, GeLU-gated) in hs's dtype."""
    u = hs @ cast(p.up, hs)
    ff = u.shape[-1] // 2
    return (gelu_tanh(u[..., :ff]) * u[..., ff:]) @ cast(p.down, hs)


def slstm_train(x, p, cfg, return_state=False):
    """x: (B, S, d) -> (B, S, d) [, the decode state after the sequence],
    token by token."""
    b, s, d = x.shape
    wx = _slstm_wx(x, p).float()                            # (B, S, 4, h, dh)
    state = slstm_init_state(cfg, b, x.device)
    hs = []
    for t in range(s):
        state, h_t = slstm_step(p, state, wx[:, t])
        hs.append(h_t)
    out = _slstm_out(torch.stack(hs, dim=1).reshape(b, s, d).to(x.dtype), p)
    return (out, state) if return_state else out


def slstm_decode(x_tok, p, cfg, state):
    """x_tok: (B, d) -> (out (B, d), the new state)."""
    state, h = slstm_step(p, state, _slstm_wx(x_tok, p))
    return _slstm_out(h.reshape(x_tok.shape).to(x_tok.dtype), p), state

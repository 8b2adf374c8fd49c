"""The serving model: embeds -> blocks -> head, the port of the JAX
package's ``repro/models/transformer.py`` for prefill and decode.

``Transformer`` is an ``nn.Module`` with one ``Block`` submodule per layer
(``cfg.layer_kinds``: the prefix, then the pattern repeated), where the JAX
package scans stacked parameters.  Its state-dict keys follow the JAX
parameter tree: ``embed``, ``final_norm.scale``, ``layers.<i>.ln1.scale``,
``layers.<i>.mixer.wq``, ``layers.<i>.ffn.w_gate``, ...;
``convert.params_from_jax`` maps a JAX tree onto them.  Matrices and the
embedding are stored in the compute dtype, the values JAX's per-use
``.astype(compute_dtype)`` of its float32 weights gives; norm scales stay
float32, as JAX reads them.

The decode state holds one KV cache per layer, ``k[i]`` and ``v[i]`` of
the layer-major stacks (L, B, Hkv, S, hd): each layer's cache is one
contiguous (B, Hkv, S, hd) tensor that the decode kernel reads in place.
``decode_step`` writes the new token's column of every layer's cache in
place and returns a state with ``pos + 1`` that shares the caches; each
step writes its own column before it reads, so a step can be run again
from the same state.

Mixers ``full``, ``local`` and ``global`` with ffn ``mlp`` are ported;
any other mixer, ffn or frontend raises NotImplementedError (ROADMAP Queue
1 lists them).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from repro_torch.kernels import ops as kops
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.models.mlp import mlp

ATTN = ("full", "local", "global")


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError unless every layer of ``cfg`` is a ported
    (mixer, ffn) pair and there is no frontend."""
    for mixer, ffn in cfg.layer_kinds:
        if mixer not in ATTN or ffn != "mlp":
            raise NotImplementedError(
                f"{cfg.name}: block ({mixer}, {ffn}) is not ported yet "
                f"(ROADMAP Queue 1); the port runs mixers {ATTN} with ffn "
                f"'mlp'")
    if cfg.frontend != "none":
        raise NotImplementedError(f"{cfg.name}: frontend {cfg.frontend!r} is "
                                  f"not ported yet (ROADMAP Queue 1)")


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)      # serving only


def _weight(shape, std, dtype, device, generator):
    """A normal(0, std) weight drawn in float32 from ``generator`` and
    stored in ``dtype``; without a generator, uninitialised storage for
    ``load_state_dict``."""
    if generator is None:
        return _param(torch.empty(shape, dtype=dtype, device=device))
    return _param(torch.randn(shape, generator=generator,
                              device=device).mul_(std).to(dtype))


def _fill(shape, value, dtype, device):
    return _param(torch.full(shape, value, dtype=dtype, device=device))


class Norm(nn.Module):
    """RMSNorm (``scale``, applied as 1 + scale, zeros at init) or
    LayerNorm (``scale`` ones and ``bias`` zeros), float32 parameters."""

    def __init__(self, cfg: ModelConfig, d: int, device):
        super().__init__()
        self.cfg = cfg
        f32 = torch.float32
        if cfg.norm == "layernorm":
            self.scale = _fill((d,), 1.0, f32, device)
            self.bias = _fill((d,), 0.0, f32, device)
        else:
            self.scale = _fill((d,), 0.0, f32, device)

    def forward(self, x):
        if self.cfg.norm == "layernorm":
            return L.layer_norm(x, self.scale, self.bias, self.cfg.norm_eps)
        return L.rms_norm(x, self.scale, self.cfg.norm_eps)


class Attention(nn.Module):
    """wq (d, H, hd), wk and wv (d, Hkv, hd), wo (H, hd, d); the optional
    qkv biases and q/k norms."""

    def __init__(self, cfg: ModelConfig, dtype, device, generator):
        super().__init__()
        d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
        std = d ** -0.5
        self.wq = _weight((d, h, hd), std, dtype, device, generator)
        self.wk = _weight((d, hkv, hd), std, dtype, device, generator)
        self.wv = _weight((d, hkv, hd), std, dtype, device, generator)
        self.wo = _weight((h, hd, d), (h * hd) ** -0.5, dtype, device,
                          generator)
        if cfg.qkv_bias:
            self.bq = _fill((h, hd), 0.0, dtype, device)
            self.bk = _fill((hkv, hd), 0.0, dtype, device)
            self.bv = _fill((hkv, hd), 0.0, dtype, device)
        if cfg.qk_norm:
            self.q_norm = _fill((hd,), 0.0, torch.float32, device)
            self.k_norm = _fill((hd,), 0.0, torch.float32, device)


class MLP(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, device, generator):
        super().__init__()
        d = cfg.d_model
        ff = cfg.dense_d_ff or cfg.d_ff
        std_in, std_out = d ** -0.5, ff ** -0.5
        if cfg.act in ("swiglu", "geglu"):
            self.w_gate = _weight((d, ff), std_in, dtype, device, generator)
            self.w_up = _weight((d, ff), std_in, dtype, device, generator)
            self.w_down = _weight((ff, d), std_out, dtype, device, generator)
        else:
            self.w_in = _weight((d, ff), std_in, dtype, device, generator)
            self.w_out = _weight((ff, d), std_out, dtype, device, generator)


class Block(nn.Module):
    """Pre-norm attention and MLP with residuals; gemma2-style post-norms
    when ``cfg.post_block_norms``."""

    def __init__(self, cfg: ModelConfig, kind, dtype, device, generator):
        super().__init__()
        self.cfg = cfg
        self.mixer_kind = kind[0]
        d = cfg.d_model
        self.ln1 = Norm(cfg, d, device)
        self.mixer = Attention(cfg, dtype, device, generator)
        if cfg.post_block_norms:
            self.ln1_post = Norm(cfg, d, device)
        self.ln2 = Norm(cfg, d, device)
        self.ffn = MLP(cfg, dtype, device, generator)
        if cfg.post_block_norms:
            self.ln2_post = Norm(cfg, d, device)

    def _finish(self, x, h):
        """Residual add of the mixer output, then the MLP half."""
        if self.cfg.post_block_norms:
            h = self.ln1_post(h)
        x = x + h
        h = mlp(self.ln2(x), self.ffn, self.cfg)
        if self.cfg.post_block_norms:
            h = self.ln2_post(h)
        return x + h

    def prefill(self, x, positions, k_cache, v_cache):
        h = L.attn_prefill(self.ln1(x), self.mixer, self.cfg,
                           self.mixer_kind, positions, k_cache, v_cache)
        return self._finish(x, h)

    def decode(self, x, pos, k_cache, v_cache, block_mask_words, backend):
        h = L.attn_decode(self.ln1(x), self.mixer, self.cfg, self.mixer_kind,
                          k_cache, v_cache, pos, block_mask_words, backend)
        return self._finish(x, h)


@dataclasses.dataclass
class DecodeState:
    """pos (B,) int32: the next position of each row; k, v (L, B, Hkv, S,
    hd): layer ``i``'s caches are ``k[i]`` and ``v[i]``."""
    pos: torch.Tensor
    k: torch.Tensor
    v: torch.Tensor


class Transformer(nn.Module):
    """The serving model on ``device`` (the card unless the caller names
    another).  With a ``generator`` the weights are random (JAX's init
    shapes and scales, drawn from that generator on ``device``); without,
    they are uninitialised, for ``load_state_dict``."""

    def __init__(self, cfg: ModelConfig, *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        dev = kops.resolve_device(device)
        self.dtype = getattr(torch, cfg.compute_dtype)
        d = cfg.d_model
        self.embed = _weight((cfg.vocab, d), d ** -0.5, self.dtype, dev,
                             generator)
        if not cfg.tie_embeddings:
            self.lm_head = _weight((d, cfg.vocab), d ** -0.5, self.dtype, dev,
                                   generator)
        self.final_norm = Norm(cfg, d, dev)
        self.layers = nn.ModuleList(
            Block(cfg, kind, self.dtype, dev, generator)
            for kind in cfg.layer_kinds)
        # sqrt(d) rounded to the compute dtype, as the JAX package scales
        # (68.0 in bfloat16 for d = 4608)
        self.embed_scale = float(torch.tensor(np.sqrt(d), dtype=self.dtype))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # ------------------------------------------------------------------
    def _embed(self, tokens):
        x = self.embed[tokens.long()]
        if self.cfg.scale_embed:
            x = x * self.embed_scale
        return x

    def _logits(self, x):
        head = self.embed.T if self.cfg.tie_embeddings else self.lm_head
        logits = x @ head
        fc = self.cfg.final_softcap
        if fc:
            logits = fc * torch.tanh(logits / fc)
        return logits

    def init_decode_state(self, batch: int, s_max: int) -> DecodeState:
        cfg = self.cfg
        shape = (len(self.layers), batch, cfg.n_kv_heads, s_max, cfg.hd)
        return DecodeState(
            torch.zeros(batch, dtype=torch.int32, device=self.device),
            torch.zeros(shape, dtype=self.dtype, device=self.device),
            torch.zeros(shape, dtype=self.dtype, device=self.device))

    @torch.no_grad()
    def prefill(self, tokens, s_max: int | None = None):
        """Process a prompt: tokens (B, S) -> (last-position logits (B, V),
        the decode state with every layer's caches filled to S)."""
        tokens = torch.as_tensor(tokens, device=self.device)
        b, s = tokens.shape
        x = self._embed(tokens)
        positions = torch.arange(s, dtype=torch.int32,
                                 device=self.device).expand(b, s)
        state = self.init_decode_state(b, s_max or s)
        state.pos.fill_(s)
        for i, block in enumerate(self.layers):
            x = block.prefill(x, positions, state.k[i], state.v[i])
        logits = self._logits(self.final_norm(x[:, -1]))
        return logits, state

    @torch.no_grad()
    def decode_step(self, state: DecodeState, tokens, block_mask_words=None,
                    *, backend=None):
        """One decode step: tokens (B,) -> (logits (B, V), the next state).

        For ``global`` mixers with ``cfg.roaring_sparse_global``,
        ``block_mask_words`` (B, words) int32 Roaring containers select the
        visible KV blocks: the block-sparse kernel on CUDA, its plain
        version on the CPU or under ``backend="ref"``."""
        tokens = torch.as_tensor(tokens, device=self.device)
        x = self._embed(tokens)
        for i, block in enumerate(self.layers):
            x = block.decode(x, state.pos, state.k[i], state.v[i],
                             block_mask_words, backend)
        logits = self._logits(self.final_norm(x))
        return logits, DecodeState(state.pos + 1, state.k, state.v)

"""The serving model: embeds -> blocks -> head, the port of the JAX
package's ``repro/models/transformer.py`` for prefill and decode.

``Transformer`` is an ``nn.Module`` with one ``Block`` submodule per layer
(``cfg.layer_kinds``: the prefix, then the pattern repeated), where the JAX
package scans stacked parameters.  Its state-dict keys follow the JAX
parameter tree: ``embed``, ``final_norm.scale``, ``layers.<i>.ln1.scale``,
``layers.<i>.mixer.wq`` (or ``.mixer.in_proj`` for Mamba),
``layers.<i>.ffn.w_gate`` (or ``.ffn.router``, ``.ffn.wg`` for MoE), ...;
``convert.params_from_jax`` maps a JAX tree onto them.  Matrices and the
embedding are stored in the compute dtype, the values JAX's per-use
``.astype(compute_dtype)`` of its float32 weights gives; norm scales, the
MoE router and Mamba's ``A_log`` stay float32, as JAX reads them.

The decode state keeps one entry a layer, as JAX's ``_mixer_state`` does:
an attention layer has its own contiguous (B, Hkv, S, hd) K and V caches
(``state.k[i]``, ``state.v[i]``), which the decode kernel reads in place; a
mamba layer has no cache but ``state.conv[i]`` (B, dc - 1, di) in the
compute dtype and ``state.h[i]`` (B, di, ds) float32.  ``decode_step``
writes the new token's column of every attention cache in place and
returns a state with ``pos + 1`` that shares the caches, and new mamba
tensors.  Each step writes its own column before it reads, and leaves the
mamba state it was given as it was, so a step can be run again from the
same state.

Mixers ``full``, ``local``, ``global`` and ``mamba`` with ffns ``mlp`` and
``moe`` are ported; any other mixer, ffn or frontend raises
NotImplementedError (ROADMAP Queue 1 lists them).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from repro_torch.kernels import ops as kops
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import fill, weight
from repro_torch.models.mlp import MLP, MoE, mlp
from repro_torch.models.ssm import (
    Mamba, mamba_decode, mamba_init_state, mamba_train,
)

ATTN = ("full", "local", "global")
MIXERS = ATTN + ("mamba",)
FFNS = ("mlp", "moe")


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError unless every layer of ``cfg`` is a ported
    (mixer, ffn) pair and there is no frontend."""
    for mixer, ffn in cfg.layer_kinds:
        if mixer not in MIXERS or ffn not in FFNS:
            raise NotImplementedError(
                f"{cfg.name}: block ({mixer}, {ffn}) is not ported yet "
                f"(ROADMAP Queue 1); the port runs mixers {MIXERS} with "
                f"ffns {FFNS}")
    if cfg.frontend != "none":
        raise NotImplementedError(f"{cfg.name}: frontend {cfg.frontend!r} is "
                                  f"not ported yet (ROADMAP Queue 1)")


class Norm(nn.Module):
    """RMSNorm (``scale``, applied as 1 + scale, zeros at init) or
    LayerNorm (``scale`` ones and ``bias`` zeros), float32 parameters."""

    def __init__(self, cfg: ModelConfig, d: int, device):
        super().__init__()
        self.cfg = cfg
        f32 = torch.float32
        if cfg.norm == "layernorm":
            self.scale = fill((d,), 1.0, f32, device)
            self.bias = fill((d,), 0.0, f32, device)
        else:
            self.scale = fill((d,), 0.0, f32, device)

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
        self.wq = weight((d, h, hd), std, dtype, device, generator)
        self.wk = weight((d, hkv, hd), std, dtype, device, generator)
        self.wv = weight((d, hkv, hd), std, dtype, device, generator)
        self.wo = weight((h, hd, d), (h * hd) ** -0.5, dtype, device,
                         generator)
        if cfg.qkv_bias:
            self.bq = fill((h, hd), 0.0, dtype, device)
            self.bk = fill((hkv, hd), 0.0, dtype, device)
            self.bv = fill((hkv, hd), 0.0, dtype, device)
        if cfg.qk_norm:
            self.q_norm = fill((hd,), 0.0, torch.float32, device)
            self.k_norm = fill((hd,), 0.0, torch.float32, device)


class Block(nn.Module):
    """Pre-norm mixer (attention or Mamba) and ffn (MLP or MoE) with
    residuals; gemma2-style post-norms when ``cfg.post_block_norms``."""

    def __init__(self, cfg: ModelConfig, kind, dtype, device, generator):
        super().__init__()
        self.cfg = cfg
        self.mixer_kind, self.ffn_kind = kind
        d = cfg.d_model
        self.ln1 = Norm(cfg, d, device)
        mixer = Mamba if self.mixer_kind == "mamba" else Attention
        self.mixer = mixer(cfg, dtype, device, generator)
        if cfg.post_block_norms:
            self.ln1_post = Norm(cfg, d, device)
        self.ln2 = Norm(cfg, d, device)
        ffn = MoE if self.ffn_kind == "moe" else MLP
        self.ffn = ffn(cfg, dtype, device, generator)
        if cfg.post_block_norms:
            self.ln2_post = Norm(cfg, d, device)

    def _finish(self, x, h):
        """Residual add of the mixer output, then the ffn half."""
        if self.cfg.post_block_norms:
            h = self.ln1_post(h)
        x = x + h
        h = self.ln2(x)
        if self.ffn_kind == "moe":
            # tokens (B, d) at decode go through as (B, 1, d), as in JAX
            h = self.ffn(h.reshape(x.shape[0], -1, x.shape[-1]))[0].reshape(
                x.shape)
        else:
            h = mlp(h, self.ffn, self.cfg)
        if self.cfg.post_block_norms:
            h = self.ln2_post(h)
        return x + h

    def prefill(self, x, positions, k_cache, v_cache):
        """x: (B, S, d) -> (x, the mamba state (conv, h) or None); an
        attention layer fills its caches in place."""
        h = self.ln1(x)
        if self.mixer_kind == "mamba":
            h, mstate = mamba_train(h, self.mixer, self.cfg,
                                    return_state=True)
        else:
            h = L.attn_prefill(h, self.mixer, self.cfg, self.mixer_kind,
                               positions, k_cache, v_cache)
            mstate = None
        return self._finish(x, h), mstate

    def decode(self, x, pos, k_cache, v_cache, conv, hstate,
               block_mask_words, backend):
        """x: (B, d) -> (x, the new mamba state (conv, h) or None)."""
        h = self.ln1(x)
        if self.mixer_kind == "mamba":
            h, mstate = mamba_decode(h, self.mixer, self.cfg, conv, hstate)
        else:
            h = L.attn_decode(h, self.mixer, self.cfg, self.mixer_kind,
                              k_cache, v_cache, pos, block_mask_words,
                              backend)
            mstate = None
        return self._finish(x, h), mstate


@dataclasses.dataclass
class DecodeState:
    """pos (B,) int32: the next position of each row; then one entry a
    layer in each list: ``k[i]`` and ``v[i]`` (B, Hkv, S, hd) for an
    attention layer, ``conv[i]`` (B, dc - 1, di) and ``h[i]`` (B, di, ds)
    float32 for a mamba layer, None where the layer has no such part."""
    pos: torch.Tensor
    k: list
    v: list
    conv: list
    h: list


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
        self.embed = weight((cfg.vocab, d), d ** -0.5, self.dtype, dev,
                            generator)
        if not cfg.tie_embeddings:
            self.lm_head = weight((d, cfg.vocab), d ** -0.5, self.dtype,
                                  dev, generator)
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
        cfg, dev = self.cfg, self.device
        n = len(self.layers)
        st = DecodeState(torch.zeros(batch, dtype=torch.int32, device=dev),
                         [None] * n, [None] * n, [None] * n, [None] * n)
        shape = (batch, cfg.n_kv_heads, s_max, cfg.hd)
        for i, block in enumerate(self.layers):
            if block.mixer_kind == "mamba":
                st.conv[i], st.h[i] = mamba_init_state(cfg, batch,
                                                       self.dtype, dev)
            else:
                st.k[i] = torch.zeros(shape, dtype=self.dtype, device=dev)
                st.v[i] = torch.zeros(shape, dtype=self.dtype, device=dev)
        return st

    @torch.no_grad()
    def prefill(self, tokens, s_max: int | None = None):
        """Process a prompt: tokens (B, S) -> (last-position logits (B, V),
        the decode state with every attention layer's caches filled to S
        and every mamba layer's state after S).  With a mamba layer, S
        longer than ``cfg.ssm_chunk`` must be a multiple of it."""
        tokens = torch.as_tensor(tokens, device=self.device)
        b, s = tokens.shape
        x = self._embed(tokens)
        positions = torch.arange(s, dtype=torch.int32,
                                 device=self.device).expand(b, s)
        state = self.init_decode_state(b, s_max or s)
        state.pos.fill_(s)
        for i, block in enumerate(self.layers):
            x, mstate = block.prefill(x, positions, state.k[i], state.v[i])
            if mstate is not None:
                state.conv[i], state.h[i] = mstate
        logits = self._logits(self.final_norm(x[:, -1]))
        return logits, state

    @torch.no_grad()
    def decode_step(self, state: DecodeState, tokens, block_mask_words=None,
                    *, backend=None):
        """One decode step: tokens (B,) -> (logits (B, V), the next state).

        For ``global`` mixers with ``cfg.roaring_sparse_global``,
        ``block_mask_words`` (B, words) int32 Roaring containers select the
        visible KV blocks: the block-sparse kernel on CUDA, its plain
        version on the CPU or under ``backend="ref"``; no other layer reads
        them."""
        tokens = torch.as_tensor(tokens, device=self.device)
        x = self._embed(tokens)
        conv, hs = list(state.conv), list(state.h)
        for i, block in enumerate(self.layers):
            x, mstate = block.decode(x, state.pos, state.k[i], state.v[i],
                                     conv[i], hs[i], block_mask_words,
                                     backend)
            if mstate is not None:
                conv[i], hs[i] = mstate
        logits = self._logits(self.final_norm(x))
        return logits, DecodeState(state.pos + 1, state.k, state.v, conv, hs)

"""The serving model: embeds -> blocks -> head, the port of the JAX
package's ``repro/models/transformer.py`` for prefill and decode.

``Transformer`` is an ``nn.Module`` with one ``Block`` submodule per layer
(``cfg.layer_kinds``: the prefix, then the pattern repeated), where the JAX
package scans stacked parameters.  Its state-dict keys follow the JAX
parameter tree: ``embed``, ``final_norm.scale``, ``frontend_proj``,
``layers.<i>.ln1.scale``, ``layers.<i>.mixer.wq`` (``.mixer.w_dkv`` for
MLA, ``.mixer.in_proj`` for Mamba, ...), ``layers.<i>.ffn.w_gate`` (or
``.ffn.router``, ``.ffn.wg`` for MoE), ...; ``convert.params_from_jax``
maps a JAX tree onto them.  For serving, matrices and the embedding are
stored in the compute dtype, the values JAX's per-use
``.astype(compute_dtype)`` of its float32 weights gives; norm scales, the
MoE router, Mamba's ``A_log`` and the xLSTM gate biases and sLSTM
recurrence stay float32, as JAX reads them.  For training
(``param_dtype="float32"``, every config) every parameter is a float32
master and each use casts it to the compute dtype (``layers.cast``), as
JAX does, so a master's gradient is the upcast compute-dtype gradient of
that use, and the two uses of a tied embedding are two casts whose
gradients sum in float32.

``loss_and_metrics`` is the JAX package's: the frontend embeddings and
the tokens embedded, every block's training forward
(``Block.train_forward``: the mixer's training form, then the ffn, which
for ``moe`` also gives the layer's router loss), the final norm, the
logits and a float32 cross entropy with label -1 masked, in
``cfg.ce_chunk`` chunks of the sequence where it is set, plus
``cfg.router_aux_coef`` times the summed router loss.  Labels shorter than
the sequence are left-padded with -1: the frontend tokens carry none.

Remat: under ``cfg.remat == "block"`` each pattern layer runs in
``torch.utils.checkpoint``.  JAX checkpoints each scanned pattern group
instead (8 layers for Jamba, 2 for xLSTM); both recompute the same
forward, so the values are the same, and one layer at a time keeps the
recompute's memory to one block's.  The prefix layers are not
checkpointed, as in JAX.

Every mixer (``full``, ``local``, ``global``, ``enc``, ``mla``, ``mamba``,
``mlstm``, ``slstm``), ffn (``mlp``, ``moe``, ``none``) and frontend
(``vision_stub``, ``audio_stub``: precomputed embeddings projected by
``frontend_proj`` and put before the tokens) of the JAX package is ported.

The decode state keeps one dict a layer, under the keys of JAX's
``_mixer_state``: an attention layer its contiguous (B, Hkv, S, hd) caches
``k`` and ``v``, which the decode kernel reads in place; an MLA layer its
compressed caches ``ckv`` (B, S, kv_lora) and ``kr`` (B, S, rope); a mamba
layer ``conv`` (B, dc - 1, di) in the compute dtype and ``h`` (B, di, ds)
float32; an mLSTM layer ``C``, ``n``, ``m`` and an sLSTM layer ``c``,
``n``, ``h``, ``m``, float32.  ``decode_step`` writes the new token's
column of every cache in place before it reads it and returns a state with
``pos + 1`` that shares the caches (the same dicts), and new recurrent
state: the state it was given keeps its recurrent tensors, so a step can
be run again from the same state.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.dist import ctx
from repro_torch.kernels import ops as kops
from repro_torch.models import layers as L
from repro_torch.models import ssm
from repro_torch.models.config import ATTN_MIXERS as ATTN
from repro_torch.models.config import FFNS, MIXERS, ModelConfig
from repro_torch.models.layers import MLA, cast, fill, weight
from repro_torch.models.mlp import MLP, MoE, mlp
from repro_torch.models.ssm import MLSTM, SLSTM, Mamba

FRONTENDS = ("none", "vision_stub", "audio_stub")


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for a mixer, ffn or frontend the JAX
    package does not know, and ValueError for an MLA layer without its
    low-rank widths (JAX's init divides by them)."""
    for mixer, ffn in cfg.layer_kinds:
        if mixer not in MIXERS or ffn not in FFNS:
            raise NotImplementedError(
                f"{cfg.name}: unknown block ({mixer}, {ffn}); mixers are "
                f"{MIXERS}, ffns {FFNS}")
    if cfg.frontend not in FRONTENDS:
        raise NotImplementedError(f"{cfg.name}: unknown frontend "
                                  f"{cfg.frontend!r}; frontends are "
                                  f"{FRONTENDS}")
    if any(m == "mla" for m, _ in cfg.layer_kinds) and not (
            cfg.q_lora_rank and cfg.kv_lora_rank):
        raise ValueError(f"{cfg.name}: an mla layer needs q_lora_rank and "
                         f"kv_lora_rank (got {cfg.q_lora_rank}, "
                         f"{cfg.kv_lora_rank})")


def _ce(logits, labels):
    """JAX's ``_ce``: logits (..., V) upcast to float32, label -1 masked ->
    (the summed negative log likelihood, the count of labels).  Under a
    device mesh the logits keep only their batch sharding, and the gold
    logit is read on each batch shard: DTensor's vocab-sharded gather (a
    masked partial) fails on the select after it (torch 2.13), and its
    backward would fill a replicated, whole-batch zero gradient."""
    dp = {0: ctx.dp_axes()}
    logits = ctx.constrain(logits.float(), dp)
    mask = labels >= 0
    safe = torch.where(mask, labels, 0).long()
    lse = torch.logsumexp(logits, dim=-1)
    gold = ctx.local_map(
        lambda lg, ix: torch.take_along_dim(lg, ix[..., None], dim=-1)[
            ..., 0], (logits, dp), (safe, dp))
    nll = torch.where(mask, lse - gold, 0.0)
    return nll.sum(), mask.sum(dtype=torch.int32)


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


_MIXERS = {"mla": MLA, "mamba": Mamba, "mlstm": MLSTM, "slstm": SLSTM}


class Block(nn.Module):
    """Pre-norm mixer and ffn (MLP, MoE, or none) with residuals;
    gemma2-style post-norms when ``cfg.post_block_norms``.  ``prefix``
    marks a layer of ``cfg.prefix``: its MLA decode is the JAX package's
    ``mla_decode``, a pattern layer's its ``mla_decode_stacked``."""

    def __init__(self, cfg: ModelConfig, kind, dtype, device, generator,
                 prefix=False):
        super().__init__()
        self.cfg = cfg
        self.mixer_kind, self.ffn_kind = kind
        self.prefix = prefix
        d = cfg.d_model
        self.ln1 = Norm(cfg, d, device)
        mixer = _MIXERS.get(self.mixer_kind, Attention)
        self.mixer = mixer(cfg, dtype, device, generator)
        if cfg.post_block_norms:
            self.ln1_post = Norm(cfg, d, device)
        if self.ffn_kind != "none":
            self.ln2 = Norm(cfg, d, device)
            ffn = MoE if self.ffn_kind == "moe" else MLP
            self.ffn = ffn(cfg, dtype, device, generator)
            if cfg.post_block_norms:
                self.ln2_post = Norm(cfg, d, device)

    def init_state(self, batch, s_max, dtype, device) -> dict:
        """This layer's decode state before any token (JAX's
        ``_mixer_state``)."""
        cfg, kind = self.cfg, self.mixer_kind

        def zeros(*shape):
            return torch.zeros(shape, dtype=dtype, device=device)

        if kind in ATTN:
            shape = (batch, cfg.n_kv_heads, s_max, cfg.hd)
            return {"k": zeros(*shape), "v": zeros(*shape)}
        if kind == "mla":
            return {"ckv": zeros(batch, s_max, cfg.kv_lora_rank),
                    "kr": zeros(batch, s_max, cfg.qk_rope_dim)}
        if kind == "mamba":
            return dict(zip(("conv", "h"), ssm.mamba_init_state(
                cfg, batch, dtype, device)))
        if kind == "mlstm":
            return ssm.mlstm_init_state(cfg, batch, device)
        return ssm.slstm_init_state(cfg, batch, device)

    def _finish(self, x, h):
        """Residual add of the mixer output, then the ffn half -> (x, the
        MoE's router loss, None for any other ffn)."""
        if self.cfg.post_block_norms:
            h = self.ln1_post(h)
        x = x + h
        aux = None
        if self.ffn_kind == "none":
            return x, aux
        h = self.ln2(x)
        if self.ffn_kind == "moe":
            # tokens (B, d) at decode go through as (B, 1, d), as in JAX
            h, metrics = self.ffn(h.reshape(x.shape[0], -1, x.shape[-1]))
            h, aux = h.reshape(x.shape), metrics["router_aux"]
        else:
            h = mlp(h, self.ffn, self.cfg)
        if self.cfg.post_block_norms:
            h = self.ln2_post(h)
        return x + h, aux

    def train_forward(self, x, positions):
        """JAX's ``block_train``: x (B, S, d) -> (x, the router loss)."""
        cfg, kind, p = self.cfg, self.mixer_kind, self.mixer
        h = self.ln1(x)
        if kind in ATTN:
            h = L.attn_train(h, p, cfg, kind, positions)
        elif kind == "mla":
            h = L.mla_train(h, p, cfg, positions)
        elif kind == "mamba":
            h = ssm.mamba_train(h, p, cfg)
        elif kind == "mlstm":
            h = ssm.mlstm_train(h, p, cfg)
        else:
            h = ssm.slstm_train(h, p, cfg)
        x, aux = self._finish(x, h)
        return x, torch.zeros((), device=x.device) if aux is None else aux

    def prefill(self, x, positions, st):
        """x: (B, S, d) -> (x, the layer's state after the sequence): an
        attention or MLA layer fills its caches in ``st`` in place and
        returns ``st``; a recurrent layer returns its new state."""
        cfg, kind, p = self.cfg, self.mixer_kind, self.mixer
        h = self.ln1(x)
        if kind in ATTN:
            h = L.attn_prefill(h, p, cfg, kind, positions, st["k"], st["v"])
        elif kind == "mla":
            h = L.mla_prefill(h, p, cfg, positions, st["ckv"], st["kr"])
        elif kind == "mamba":
            h, (conv, hs) = ssm.mamba_train(h, p, cfg, return_state=True)
            st = {"conv": conv, "h": hs}
        elif kind == "mlstm":
            h, st = ssm.mlstm_train(h, p, cfg, return_state=True)
        else:
            h, st = ssm.slstm_train(h, p, cfg, return_state=True)
        return self._finish(x, h)[0], st

    def decode(self, x, pos, st, block_mask_words, backend):
        """x: (B, d) -> (x, the layer's next state): the same dict for an
        attention or MLA layer (its caches written in place), a new one for
        a recurrent layer."""
        cfg, kind, p = self.cfg, self.mixer_kind, self.mixer
        h = self.ln1(x)
        if kind in ATTN:
            h = L.attn_decode(h, p, cfg, kind, st["k"], st["v"], pos,
                              block_mask_words, backend)
        elif kind == "mla":
            h = L.mla_decode(h, p, cfg, st["ckv"], st["kr"], pos,
                             ctx_f32=self.prefix)
        elif kind == "mamba":
            h, (conv, hs) = ssm.mamba_decode(h, p, cfg, st["conv"], st["h"])
            st = {"conv": conv, "h": hs}
        elif kind == "mlstm":
            h, st = ssm.mlstm_decode(h, p, cfg, st)
        else:
            h, st = ssm.slstm_decode(h, p, cfg, st)
        return self._finish(x, h)[0], st


@dataclasses.dataclass
class DecodeState:
    """pos (B,) int32: the next position of each row; ``layers[i]``: layer
    i's state, a dict under JAX's ``_mixer_state`` keys (see the module
    docstring)."""
    pos: torch.Tensor
    layers: list


class Transformer(nn.Module):
    """The model on ``device`` (the card unless the caller names another).
    With a ``generator`` the weights are random (JAX's init shapes and
    scales, drawn in float32 from that generator on ``device``); without,
    they are uninitialised, for ``load_state_dict``.  ``param_dtype``
    (default: the compute dtype, for serving) is the dtype the matrices are
    stored in; ``"float32"`` gives the training model's masters."""

    def __init__(self, cfg: ModelConfig, *, device=None,
                 generator: torch.Generator | None = None,
                 param_dtype: str | None = None):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        dev = kops.resolve_device(device)
        self.dtype = getattr(torch, cfg.compute_dtype)
        wdt = getattr(torch, param_dtype) if param_dtype else self.dtype
        d = cfg.d_model
        self.embed = weight((cfg.vocab, d), d ** -0.5, wdt, dev, generator)
        if not cfg.tie_embeddings:
            self.lm_head = weight((d, cfg.vocab), d ** -0.5, wdt, dev,
                                  generator)
        if cfg.frontend != "none":
            fd = cfg.frontend_dim or d
            self.frontend_proj = weight((fd, d), fd ** -0.5, wdt, dev,
                                        generator)
        self.final_norm = Norm(cfg, d, dev)
        n_prefix = len(cfg.prefix)
        self.layers = nn.ModuleList(
            Block(cfg, kind, wdt, dev, generator, prefix=i < n_prefix)
            for i, kind in enumerate(cfg.layer_kinds))
        # sqrt(d) rounded to the compute dtype, as the JAX package scales
        # (68.0 in bfloat16 for d = 4608)
        self.embed_scale = float(torch.tensor(np.sqrt(d), dtype=self.dtype))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # ------------------------------------------------------------------
    def _embed(self, tokens=None, frontend_embeds=None):
        """JAX's ``_embed_inputs``: the frontend embeddings (B, F, fd)
        projected to d, then the token embeddings (B, S), joined along the
        sequence and scaled together."""
        parts = []
        if frontend_embeds is not None:
            if self.cfg.frontend == "none":
                raise ValueError(f"{self.cfg.name} has no frontend for "
                                 f"frontend_embeds")
            fe = torch.as_tensor(frontend_embeds,
                                 device=self.device).to(self.dtype)
            parts.append(fe @ cast(self.frontend_proj, fe))
        if tokens is not None:
            tokens = torch.as_tensor(tokens, device=self.device)
            # cast, then gather: the gather's backward accumulates repeated
            # tokens in the compute dtype, as JAX's does
            parts.append(L.gather_rows(self.embed.to(self.dtype),
                                       tokens.long()))
        if not parts:
            raise ValueError("prefill needs tokens, frontend_embeds or both")
        x = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
        if self.cfg.scale_embed:
            x = x * self.embed_scale
        return x

    def _logits(self, x):
        head = self.embed.T if self.cfg.tie_embeddings else self.lm_head
        logits = x @ cast(head, x)
        fc = self.cfg.final_softcap
        if fc:
            logits = fc * torch.tanh(logits / fc)
        return logits

    # ------------------------------------------------------------------
    def backbone(self, x, positions):
        """JAX's ``backbone``: every block's training forward, then the
        final norm -> (x, the summed router loss).  Under ``cfg.remat ==
        "block"`` each pattern layer's activations are recomputed in the
        backward pass (see the module docstring)."""
        aux_total = torch.zeros((), device=x.device)
        n_prefix = len(self.cfg.prefix)
        for i, block in enumerate(self.layers):
            if self.cfg.remat == "block" and i >= n_prefix:
                x, aux = checkpoint(block.train_forward, x, positions,
                                    use_reentrant=False)
            else:
                x, aux = block.train_forward(x, positions)
            aux_total = aux_total + aux
        return self.final_norm(x), aux_total

    def loss_and_metrics(self, batch):
        """JAX's ``loss_and_metrics``: batch {"tokens": (B, S)} and/or
        {"frontend_embeds": (B, F, frontend_dim)}, which go first, and
        "labels" (B, L), L <= F + S, left-padded with -1 to F + S; label -1
        masked -> (loss, {"ce_loss", "router_aux", "tokens"}),
        differentiable in the parameters."""
        x = self._embed(batch.get("tokens"), batch.get("frontend_embeds"))
        x = ctx.constrain(x, {0: ctx.dp_axes()})    # JAX's _embed_inputs
        b, s = x.shape[:2]
        positions = torch.arange(s, dtype=torch.int32,
                                 device=self.device).expand(b, s)
        x, aux = self.backbone(x, positions)
        labels = torch.as_tensor(batch["labels"], device=self.device)
        pad = s - labels.shape[1]
        if pad < 0:
            raise ValueError(f"{labels.shape[1]} labels for a sequence of "
                             f"{s}")
        if pad:               # the frontend tokens carry no labels; under a
            # mesh padded on each batch shard (DTensor's pad fails in some
            # torch versions)
            labels = ctx.local_map(
                lambda t: torch.nn.functional.pad(t, (pad, 0), value=-1),
                (labels, {0: ctx.dp_axes()}))
        c = min(self.cfg.ce_chunk, s) if self.cfg.ce_chunk else s
        if s % c:
            raise ValueError(f"sequence {s} is not a multiple of ce_chunk "
                             f"{c}")
        nll = torch.zeros((), device=self.device)
        n = torch.zeros((), dtype=torch.int32, device=self.device)
        for c0 in range(0, s, c):
            nll_c, n_c = _ce(self._logits(x[:, c0:c0 + c]),
                             labels[:, c0:c0 + c])
            nll, n = nll + nll_c, n + n_c
        loss = nll / torch.clamp(n, min=1)
        total = loss + self.cfg.router_aux_coef * aux
        return total, {"ce_loss": loss, "router_aux": aux, "tokens": n}

    def init_decode_state(self, batch: int, s_max: int, *,
                          device=None) -> DecodeState:
        dev = self.device if device is None else device
        return DecodeState(
            torch.zeros(batch, dtype=torch.int32, device=dev),
            [block.init_state(batch, s_max, self.dtype, dev)
             for block in self.layers])

    def placed_decode_state(self, batch: int, s_max: int, mesh):
        """:meth:`init_decode_state` as DTensors on ``mesh``, placed by
        ``dist.sharding.decode_state_shardings``, each device allocating
        only its own shard (every leaf starts as one constant, read from a
        one-token state on the host).  The global shapes and the host
        state are built outside any dispatch mode, so a counter
        (``launch.op_analysis.OpAnalysis``) sees only the shards, which it
        counts as ``decode_state``."""
        from torch.distributed.tensor import DTensor
        from torch.utils._python_dispatch import _disable_current_modes

        from repro_torch.dist import sharding as SH
        from repro_torch.launch.op_analysis import labelled
        with _disable_current_modes():
            shapes = self.init_decode_state(batch, s_max, device="meta")
            fills = dict(SH.leaves_with_path(
                self.init_decode_state(1, 1, device="cpu")))
        shardings = dict(SH.leaves_with_path(SH.decode_state_shardings(
            shapes, mesh, pure_dp=ctx.pure_dp())))

        def leaf(path, t):
            s = shardings[path]
            local = torch.full(s.shard_shape(t.shape),
                               fills[path].reshape(-1)[0].item(),
                               dtype=t.dtype, device=self.device)
            return DTensor.from_local(local, mesh, s.placements(),
                                      run_check=False, shape=t.shape,
                                      stride=t.stride())
        with labelled("decode_state"):
            return SH.map_with_path(leaf, shapes)

    @torch.no_grad()
    def prefill(self, tokens=None, s_max: int | None = None, *,
                frontend_embeds=None):
        """Process a prompt: tokens (B, S) and/or ``frontend_embeds`` (B, F,
        frontend_dim), which go first -> (last-position logits (B, V), the
        decode state with every cache filled to F + S and every recurrent
        layer's state after them).  With a mamba layer, F + S longer than
        ``cfg.ssm_chunk`` must be a multiple of it."""
        x = ctx.constrain(self._embed(tokens, frontend_embeds),
                          {0: ctx.dp_axes()})
        b, s = x.shape[:2]
        positions = torch.arange(s, dtype=torch.int32,
                                 device=self.device).expand(b, s)
        if ctx.is_dtensor(x) and ctx.current_mesh() is not None:
            state = self.placed_decode_state(b, s_max or s, x.device_mesh)
        else:
            state = self.init_decode_state(b, s_max or s)
        state.pos.fill_(s)
        for i, block in enumerate(self.layers):
            x, state.layers[i] = block.prefill(x, positions, state.layers[i])
        logits = self._logits(self.final_norm(x[:, -1]))
        return logits, state

    @torch.no_grad()
    def decode_step(self, state: DecodeState, tokens, block_mask_words=None,
                    *, backend=None):
        """One decode step: tokens (B,) -> (logits (B, V), the next state).

        For ``global`` mixers with ``cfg.roaring_sparse_global``,
        ``block_mask_words`` (B, words) int32 Roaring containers select the
        visible KV blocks: the block-sparse kernel on CUDA, its plain
        version on the CPU or under ``backend="ref"``, or the gather route
        where ``cfg.sparse_topk_blocks`` is set; no other layer reads
        them."""
        x = self._embed(tokens)
        layers = []
        for block, st in zip(self.layers, state.layers, strict=True):
            x, st = block.decode(x, state.pos, st, block_mask_words, backend)
            layers.append(st)
        logits = self._logits(self.final_norm(x))
        return logits, DecodeState(state.pos + 1, layers)

"""Assigned architectures x input shapes, copied from the JAX package's
``repro.configs`` (numpy-only dataclass constructors).

Each ``repro_torch.configs.<arch_id>`` module exposes ``config()`` (the
exact published configuration) and ``reduced()`` (a small same-family
config for CPU tests).  This package adds the shape grid, the
applicability rules and the dry run's input specs: meta tensors (shapes and
dtypes, no storage) where the JAX package has ``ShapeDtypeStruct``.  The
Roaring mask words are ``torch.int32`` holding the uint32 bits, as
everywhere in the port.
"""

from __future__ import annotations

import dataclasses
import importlib

import torch

from repro_torch.models.config import ModelConfig

ARCH_IDS = (
    "qwen2_vl_72b",
    "gemma2_27b",
    "stablelm_3b",
    "qwen2_5_3b",
    "qwen3_14b",
    "deepseek_v2_236b",
    "mixtral_8x7b",
    "xlstm_350m",
    "jamba_v01_52b",
    "hubert_xlarge",
)

# CLI-friendly aliases (--arch qwen2-vl-72b etc.)
ALIASES = {a.replace("_", "-"): a for a in ARCH_IDS}
ALIASES.update({"qwen2.5-3b": "qwen2_5_3b", "jamba-v0.1-52b": "jamba_v01_52b"})


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    step: str        # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def get_config(arch: str, reduced: bool = False) -> ModelConfig:
    arch = ALIASES.get(arch, arch)
    if arch not in ARCH_IDS:
        raise ValueError(f"unknown architecture {arch!r}; expected one of "
                         f"{ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return mod.reduced() if reduced else mod.config()


def all_configs(reduced: bool = False) -> dict[str, ModelConfig]:
    return {a: get_config(a, reduced) for a in ARCH_IDS}


def applicable(cfg: ModelConfig, shape: str) -> tuple[bool, str]:
    spec = SHAPES[shape]
    if cfg.is_encoder and spec.step == "decode":
        return False, "encoder-only architecture has no decode step"
    if shape == "long_500k" and cfg.full_attention_only:
        return False, ("pure full-attention architecture: long_500k needs "
                       "sub-quadratic attention (skip per assignment)")
    return True, ""


def grid(reduced: bool = False):
    """All 40 (arch, shape) cells with applicability annotations."""
    cells = []
    for a in ARCH_IDS:
        cfg = get_config(a, reduced)
        for s in SHAPES:
            ok, why = applicable(cfg, s)
            cells.append((a, s, ok, why))
    return cells


# ---------------------------------------------------------------------------
# dry-run input specs (meta tensors, no allocation)
# ---------------------------------------------------------------------------

def _spec(shape) -> ShapeSpec:
    return SHAPES[shape] if isinstance(shape, str) else shape


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape) -> dict:
    """Model *data* inputs for the given shape's step function (a name of
    ``SHAPES`` or a ``ShapeSpec``), as meta tensors."""
    spec = _spec(shape)
    b, s = spec.global_batch, spec.seq_len
    i32, bf16 = torch.int32, torch.bfloat16
    fd = cfg.frontend_dim or cfg.d_model
    if spec.step == "train":
        batch = {}
        s_text = s - cfg.n_frontend_tokens
        if cfg.frontend == "none":
            batch["tokens"] = _meta((b, s), i32)
            batch["labels"] = _meta((b, s), i32)
        elif cfg.frontend == "vision_stub":
            batch["frontend_embeds"] = _meta(
                (b, cfg.n_frontend_tokens, fd), bf16)
            batch["tokens"] = _meta((b, s_text), i32)
            batch["labels"] = _meta((b, s_text), i32)
        else:  # audio_stub: pure embedding input
            batch["frontend_embeds"] = _meta((b, s, fd), bf16)
            batch["labels"] = _meta((b, s), i32)
        return batch
    if spec.step == "prefill":
        batch = {}
        if cfg.frontend == "audio_stub":
            batch["frontend_embeds"] = _meta((b, s, fd), bf16)
        elif cfg.frontend == "vision_stub":
            batch["frontend_embeds"] = _meta(
                (b, cfg.n_frontend_tokens, fd), bf16)
            batch["tokens"] = _meta((b, s - cfg.n_frontend_tokens), i32)
        else:
            batch["tokens"] = _meta((b, s), i32)
        return batch
    # decode: one new token over a seq_len-deep KV/state cache
    out = {"tokens": _meta((b,), i32)}
    if cfg.roaring_sparse_global and cfg.has_attention:
        n_blocks = s // cfg.attn_block_size
        out["block_mask_words"] = _meta((b, max(1, (n_blocks + 31) // 32)),
                                        i32)
    return out


def decode_state_specs(cfg: ModelConfig, shape):
    """The decode state of a ``shape``-deep cache on meta tensors: the
    port's ``DecodeState`` (``pos`` and one dict a layer)."""
    from repro_torch.models.transformer import Transformer
    spec = _spec(shape)
    return Transformer(cfg, device="meta").init_decode_state(
        spec.global_batch, spec.seq_len)

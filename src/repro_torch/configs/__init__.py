"""Assigned architectures x input shapes, copied from the JAX package's
``repro.configs`` (numpy-only dataclass constructors).

Each ``repro_torch.configs.<arch_id>`` module exposes ``config()`` (the
exact published configuration) and ``reduced()`` (a small same-family
config for CPU tests).  This package adds the shape grid and the
applicability rules; the dry run's input specs are not ported (ROADMAP
Queue 1).
"""

from __future__ import annotations

import dataclasses
import importlib

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


def applicable(cfg: ModelConfig, shape: str) -> tuple[bool, str]:
    spec = SHAPES[shape]
    if cfg.is_encoder and spec.step == "decode":
        return False, "encoder-only architecture has no decode step"
    if shape == "long_500k" and cfg.full_attention_only:
        return False, ("pure full-attention architecture: long_500k needs "
                       "sub-quadratic attention (skip per assignment)")
    return True, ""

"""qwen3-14b [dense]: 40L d=5120 40H (GQA kv=8) ff=17408 vocab=151936,
qk_norm + GQA [hf:Qwen/Qwen3].

A beyond-paper `+roaring-sparse` variant (roaring_sparse_global=True on the
full-attention mixers promoted to 'global') is dry-run as a demo of applying
the paper's block-mask technique to a full-attention arch -- see
EXPERIMENTS.md sec Perf."""

import dataclasses

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-14b", family="dense",
        n_layers=40, d_model=5120, n_heads=40, n_kv_heads=8,
        d_ff=17408, vocab=151936, head_dim=128,
        pattern=(("full", "mlp"),),
        rope_theta=1e6, qk_norm=True,
    )


def roaring_sparse_variant() -> ModelConfig:
    base = config()
    return dataclasses.replace(
        base, name="qwen3-14b+roaring-sparse",
        pattern=(("global", "mlp"),), roaring_sparse_global=True)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="qwen3-14b-reduced", family="dense",
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
        d_ff=256, vocab=512, head_dim=32,
        pattern=(("full", "mlp"),),
        rope_theta=1e6, qk_norm=True,
        attn_q_chunk=64, attn_k_chunk=64,
    )

"""mixtral-8x7b [moe]: 32L d=4096 32H (GQA kv=8) ff=14336 vocab=32000,
8 experts top-2, sliding-window attention [arXiv:2401.04088].

SWA makes decode cost O(window) per token -- natively sub-quadratic, so
long_500k runs (DESIGN.md sec 8)."""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x7b", family="moe",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=14336, vocab=32000,
        pattern=(("local", "moe"),),
        n_experts=8, moe_top_k=2, moe_d_ff=14336,
        sliding_window=4096,
        rope_theta=1e6,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x7b-reduced", family="moe",
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
        d_ff=256, vocab=512,
        pattern=(("local", "moe"),),
        n_experts=4, moe_top_k=2, moe_d_ff=256,
        sliding_window=64,
        attn_q_chunk=64, attn_k_chunk=64,
    )

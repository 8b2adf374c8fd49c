"""jamba-v0.1-52b [hybrid]: 32L d=4096 32H (GQA kv=8) ff=14336 vocab=65536,
Mamba + attention 1:7 interleave, 16-expert top-2 MoE every other layer
[arXiv:2403.19887].

The single attention layer per 8-layer period is a 'global' mixer consuming
Roaring block-sparse masks at decode; mamba layers carry O(1) state ->
long_500k runs sub-quadratically (DESIGN.md sec 8)."""

from repro_torch.models.config import ModelConfig

_PERIOD = (
    ("mamba", "mlp"), ("mamba", "moe"), ("mamba", "mlp"), ("mamba", "moe"),
    ("global", "mlp"), ("mamba", "moe"), ("mamba", "mlp"), ("mamba", "moe"),
)


def config() -> ModelConfig:
    return ModelConfig(
        name="jamba-v0.1-52b", family="hybrid",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=14336, vocab=65536,
        pattern=_PERIOD,
        n_experts=16, moe_top_k=2, moe_d_ff=14336,
        ssm_d_state=16, ssm_d_conv=4, ssm_expand=2,
        roaring_sparse_global=True,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="jamba-v0.1-52b-reduced", family="hybrid",
        n_layers=8, d_model=128, n_heads=4, n_kv_heads=2,
        d_ff=256, vocab=512,
        pattern=_PERIOD,
        n_experts=4, moe_top_k=2, moe_d_ff=256,
        ssm_d_state=8, ssm_d_conv=4, ssm_expand=2,
        roaring_sparse_global=True,
        attn_q_chunk=64, attn_k_chunk=64,
    )

"""gemma2-27b [dense]: 46L d=4608 32H (GQA kv=16) ff=36864 vocab=256000,
local+global alternating attention, logit softcaps [arXiv:2408.00118].

Long-context note (DESIGN.md sec 8): local layers are natively sliding-window;
global layers consume Roaring block-sparse masks at decode, making long_500k
sub-quadratic -- the paper-technique integration path."""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-27b", family="dense",
        n_layers=46, d_model=4608, n_heads=32, n_kv_heads=16,
        d_ff=36864, vocab=256000, head_dim=128,
        pattern=(("local", "mlp"), ("global", "mlp")),
        rope_theta=10000.0,
        attn_softcap=50.0, final_softcap=30.0,
        sliding_window=4096,
        post_block_norms=True, scale_embed=True,
        tie_embeddings=True, act="geglu",
        roaring_sparse_global=True,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="gemma2-27b-reduced", family="dense",
        n_layers=4, d_model=128, n_heads=4, n_kv_heads=2,
        d_ff=256, vocab=512, head_dim=32,
        pattern=(("local", "mlp"), ("global", "mlp")),
        attn_softcap=50.0, final_softcap=30.0,
        sliding_window=64,
        post_block_norms=True, scale_embed=True,
        tie_embeddings=True, act="geglu",
        roaring_sparse_global=True,
        attn_q_chunk=64, attn_k_chunk=64,
    )

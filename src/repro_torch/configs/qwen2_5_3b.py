"""qwen2.5-3b [dense]: 36L d=2048 16H (GQA kv=2) ff=11008 vocab=151936,
GQA + QKV bias, tied embeddings [hf:Qwen/Qwen2.5]."""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-3b", family="dense",
        n_layers=36, d_model=2048, n_heads=16, n_kv_heads=2,
        d_ff=11008, vocab=151936,
        pattern=(("full", "mlp"),),
        rope_theta=1e6, qkv_bias=True, tie_embeddings=True,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-3b-reduced", family="dense",
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
        d_ff=256, vocab=512,
        pattern=(("full", "mlp"),),
        rope_theta=1e6, qkv_bias=True, tie_embeddings=True,
        attn_q_chunk=64, attn_k_chunk=64,
    )

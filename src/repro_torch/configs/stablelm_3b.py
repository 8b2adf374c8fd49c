"""stablelm-3b [dense]: 32L d=2560 32H (MHA kv=32) ff=6912 vocab=50304
[hf:stabilityai/stablelm; unverified tier].  LayerNorm, standard RoPE."""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="stablelm-3b", family="dense",
        n_layers=32, d_model=2560, n_heads=32, n_kv_heads=32,
        d_ff=6912, vocab=50304,
        pattern=(("full", "mlp"),),
        norm="layernorm", norm_eps=1e-5,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="stablelm-3b-reduced", family="dense",
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
        d_ff=256, vocab=512,
        pattern=(("full", "mlp"),),
        norm="layernorm", norm_eps=1e-5,
        attn_q_chunk=64, attn_k_chunk=64,
    )

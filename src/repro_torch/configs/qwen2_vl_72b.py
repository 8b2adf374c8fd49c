"""qwen2-vl-72b [vlm]: 80L d=8192 64H (GQA kv=8) ff=29568 vocab=152064,
M-RoPE, dynamic resolution [arXiv:2409.12191].  Vision frontend is a STUB
per the assignment: input_specs feeds precomputed patch embeddings."""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-72b", family="vlm",
        n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
        d_ff=29568, vocab=152064, head_dim=128,
        pattern=(("full", "mlp"),),
        rope_theta=1e6, qkv_bias=True,
        m_rope_sections=(16, 24, 24),
        frontend="vision_stub", n_frontend_tokens=256, frontend_dim=1280,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-72b-reduced", family="vlm",
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
        d_ff=256, vocab=512, head_dim=32,
        pattern=(("full", "mlp"),),
        rope_theta=1e6, qkv_bias=True,
        m_rope_sections=(4, 6, 6),
        frontend="vision_stub", n_frontend_tokens=8, frontend_dim=48,
        attn_q_chunk=64, attn_k_chunk=64,
    )

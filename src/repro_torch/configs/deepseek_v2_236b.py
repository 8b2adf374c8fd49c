"""deepseek-v2-236b [moe]: 60L d=5120 128H ff(expert)=1536 vocab=102400,
MLA kv_lora=512, 2 shared + 160 routed experts top-6; first layer dense
[arXiv:2405.04434]."""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-236b", family="moe",
        n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128,
        d_ff=1536, vocab=102400,
        prefix=(("mla", "mlp"),),
        pattern=(("mla", "moe"),),
        q_lora_rank=1536, kv_lora_rank=512,
        qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
        n_experts=160, moe_top_k=6, n_shared_experts=2,
        moe_d_ff=1536, dense_d_ff=12288,
        rope_theta=10000.0,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-236b-reduced", family="moe",
        n_layers=3, d_model=128, n_heads=4, n_kv_heads=4,
        d_ff=64, vocab=512,
        prefix=(("mla", "mlp"),),
        pattern=(("mla", "moe"),),
        q_lora_rank=48, kv_lora_rank=32,
        qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16,
        n_experts=8, moe_top_k=2, n_shared_experts=1,
        moe_d_ff=64, dense_d_ff=256,
        attn_q_chunk=64, attn_k_chunk=64,
    )

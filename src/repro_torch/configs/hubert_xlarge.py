"""hubert-xlarge [audio]: 48L d=1280 16H ff=5120 vocab=504 encoder-only
(w2v2 arch) [arXiv:2106.07447; unverified tier].

Encoder-only: decode_32k and long_500k are skipped per the assignment; the
audio frontend is a STUB (input_specs feeds precomputed 512-dim conv-frame
embeddings).  Training is masked-unit prediction over the 504-unit
codebook."""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="hubert-xlarge", family="audio",
        n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16,
        d_ff=5120, vocab=504,
        pattern=(("enc", "mlp"),),
        norm="layernorm", norm_eps=1e-5, act="gelu",
        frontend="audio_stub", frontend_dim=512,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="hubert-xlarge-reduced", family="audio",
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
        d_ff=256, vocab=64,
        pattern=(("enc", "mlp"),),
        norm="layernorm", norm_eps=1e-5, act="gelu",
        frontend="audio_stub", frontend_dim=48,
        attn_q_chunk=64, attn_k_chunk=64,
    )

"""xlstm-350m [ssm]: 24L d=1024 4 heads vocab=50304, alternating
mLSTM / sLSTM blocks, no FFN (d_ff=0) [arXiv:2405.04517; unverified tier].

Attention-free: the paper's block-mask technique is inapplicable at the
attention layer (DESIGN.md sec 8 Arch-applicability); the data-pipeline /
constrained-decoding Roaring integrations still apply.  O(1) decode state
-> long_500k runs."""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-350m", family="ssm",
        n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4,
        d_ff=0, vocab=50304,
        pattern=(("mlstm", "none"), ("slstm", "none")),
        xlstm_heads=4, ssm_expand=2,
        xlstm_chunk=64,   # chunkwise-parallel mLSTM (EXPERIMENTS.md sec Perf)
        pure_dp=True,     # 350M params: TP would cost more than it saves
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="xlstm-350m-reduced", family="ssm",
        n_layers=4, d_model=128, n_heads=4, n_kv_heads=4,
        d_ff=0, vocab=512,
        pattern=(("mlstm", "none"), ("slstm", "none")),
        xlstm_heads=4, ssm_expand=2,
    )

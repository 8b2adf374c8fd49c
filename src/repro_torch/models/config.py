"""Model configuration for every assigned architecture family.

A model is a (prefix + repeated pattern) of blocks.  Each block is a
(mixer, ffn) pair:

  mixer: full | local | global | mla | mamba | mlstm | slstm | enc
  ffn  : mlp | moe | none

`full` is causal full attention; `local` is sliding-window attention;
`global` is full attention that can consume a Roaring block-sparse mask at
decode (the paper integration, DESIGN.md section 2); `enc` is bidirectional
(encoder-only); `mla` is DeepSeek-V2 multi-head latent attention; `mamba`,
`mlstm`, `slstm` are the SSM/xLSTM mixers.

The pattern structure is what lets the whole stack lower as a
scan-over-layer-groups: parameters of each position in the pattern are
stacked across repeats, so the HLO size is independent of depth.
"""

from __future__ import annotations

import dataclasses

Mixer = str
Ffn = str
BlockKind = tuple[Mixer, Ffn]

MIXERS = ("full", "local", "global", "mla", "mamba", "mlstm", "slstm", "enc")
FFNS = ("mlp", "moe", "none")

ATTN_MIXERS = ("full", "local", "global", "enc")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                # 0 -> d_model // n_heads
    # layer plan
    prefix: tuple[BlockKind, ...] = ()
    pattern: tuple[BlockKind, ...] = (("full", "mlp"),)
    # attention
    rope_theta: float = 10000.0
    qkv_bias: bool = False
    qk_norm: bool = False
    attn_softcap: float = 0.0        # 0 disables
    final_softcap: float = 0.0
    sliding_window: int = 0          # for 'local' mixers
    m_rope_sections: tuple[int, int, int] | None = None
    # MLA
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    # MoE
    n_experts: int = 0
    moe_top_k: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0
    dense_d_ff: int = 0              # ff of dense ("mlp") blocks if distinct
    moe_dispatch: str = "scatter"    # scatter | dense
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    # SSM
    ssm_d_state: int = 16
    ssm_d_conv: int = 4
    ssm_expand: int = 2
    ssm_dt_rank: int = 0             # 0 -> ceil(d_model / 16)
    ssm_chunk: int = 128
    xlstm_heads: int = 4
    xlstm_chunk: int = 0          # 0 = sequential scan; >0 = chunkwise-parallel mLSTM
    # norms / embeddings / activations
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    norm_eps: float = 1e-6
    post_block_norms: bool = False   # gemma2-style extra post-norms
    scale_embed: bool = False        # gemma-style sqrt(d) embedding scale
    tie_embeddings: bool = False
    act: str = "swiglu"              # swiglu | geglu | gelu
    # modality frontend (STUB per assignment: precomputed embeddings)
    frontend: str = "none"           # none | vision_stub | audio_stub
    n_frontend_tokens: int = 0
    frontend_dim: int = 0            # embedding dim fed by the stub
    # roaring integration (paper technique)
    roaring_sparse_global: bool = False
    attn_block_size: int = 128
    sparse_topk_blocks: int = 0   # >0: gather-based sparse decode (per-request cap)
    # numerics / training-perf knobs (hillclimb levers, EXPERIMENTS.md sec Perf)
    pure_dp: bool = False            # small models: replicate params, DP only
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: str = "block"             # none | block
    ce_chunk: int = 0                # 0 = full logits; >0 = chunked CE vocab tile
    attn_q_chunk: int = 512
    attn_k_chunk: int = 1024
    flash_block_skip: bool = True    # skip fully-masked KV blocks (beyond-paper; exact)

    # ------------------------------------------------------------------
    def __post_init__(self):
        assert self.family in ("dense", "moe", "ssm", "hybrid", "audio", "vlm")
        n_patterned = self.n_layers - len(self.prefix)
        assert n_patterned >= 0 and n_patterned % len(self.pattern) == 0, (
            f"{self.name}: {self.n_layers} layers, prefix {len(self.prefix)}, "
            f"pattern {len(self.pattern)}")
        for mixer, ffn in self.prefix + self.pattern:
            assert mixer in MIXERS and ffn in FFNS, (mixer, ffn)

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def n_repeats(self) -> int:
        return (self.n_layers - len(self.prefix)) // len(self.pattern)

    @property
    def layer_kinds(self) -> tuple[BlockKind, ...]:
        return self.prefix + self.pattern * self.n_repeats

    @property
    def is_encoder(self) -> bool:
        return any(m == "enc" for m, _ in self.layer_kinds)

    @property
    def has_attention(self) -> bool:
        return any(m in ATTN_MIXERS or m == "mla" for m, _ in self.layer_kinds)

    @property
    def full_attention_only(self) -> bool:
        """True when every mixer is unbounded-window attention (the archs for
        which long_500k is skipped per the assignment)."""
        mixers = {m for m, _ in self.layer_kinds}
        if not mixers <= {"full", "mla", "enc", "global"}:
            return False
        # 'global' with roaring sparsity is sub-quadratic; plain global isn't
        return not self.roaring_sparse_global

    def params_count(self) -> int:
        """Approximate parameter count N (for the 6*N*D model-FLOPs line)."""
        d, hd = self.d_model, self.hd
        total = self.vocab * d * (1 if self.tie_embeddings else 2)
        for mixer, ffn in self.layer_kinds:
            if mixer in ("full", "local", "global", "enc"):
                total += d * hd * (self.n_heads + 2 * self.n_kv_heads)
                total += self.n_heads * hd * d
            elif mixer == "mla":
                total += d * self.q_lora_rank
                total += self.q_lora_rank * self.n_heads * (
                    self.qk_nope_dim + self.qk_rope_dim)
                total += d * (self.kv_lora_rank + self.qk_rope_dim)
                total += self.kv_lora_rank * self.n_heads * (
                    self.qk_nope_dim + self.v_head_dim)
                total += self.n_heads * self.v_head_dim * d
            elif mixer == "mamba":
                di = self.ssm_expand * d
                dt = self.ssm_dt_rank or -(-d // 16)
                total += d * 2 * di + di * (dt + 2 * self.ssm_d_state)
                total += dt * di + di * self.ssm_d_state + di * d
            elif mixer == "mlstm":
                di = self.ssm_expand * d
                total += d * 2 * di + 3 * di * di + 2 * di * self.xlstm_heads
                total += di * d
            elif mixer == "slstm":
                dh = d // self.xlstm_heads
                total += 4 * d * d + 4 * self.xlstm_heads * dh * dh
                total += d * (4 * d) // 3 * 2
            if ffn == "mlp":
                ff = self.dense_d_ff or self.d_ff
                mult = 3 if self.act in ("swiglu", "geglu") else 2
                total += mult * d * ff
            elif ffn == "moe":
                ff = self.moe_d_ff or self.d_ff
                total += d * self.n_experts
                total += 3 * self.n_experts * d * ff
                total += 3 * self.n_shared_experts * d * ff
        return total

    def active_params_count(self) -> int:
        """N_active for MoE archs (6*N_active*D)."""
        if self.n_experts == 0:
            return self.params_count()
        d = self.d_model
        ff = self.moe_d_ff or self.d_ff
        per_expert = 3 * d * ff
        inactive = sum(
            (self.n_experts - self.moe_top_k) * per_expert
            for _, f in self.layer_kinds if f == "moe")
        return self.params_count() - inactive

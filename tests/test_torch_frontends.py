"""The port's encoder mixer (``enc``: bidirectional attention) and modality
frontends (``vision_stub``, ``audio_stub``: precomputed embeddings through
``frontend_proj``, placed before the tokens; M-RoPE sections) against the
JAX package's, with the reduced ``hubert_xlarge`` (encoder-only, audio
embeddings, layernorm, GeLU) and ``qwen2_vl_72b`` (vision embeddings then
text tokens, qkv bias, M-RoPE sections (4, 6, 6)) configs and the JAX
weights carried across.

Tolerances: the modules against JAX run op by op, float32 1e-5, bfloat16
within one bf16 ulp of each row's largest value; the whole models against
JAX compiled with ``allow_excess_precision`` off at
``tests/test_torch_hybrid.py``'s tolerances.  HuBERT is prefill only, as
the JAX launcher refuses to decode an encoder; Qwen2-VL decodes 4
teacher-forced tokens after a prefill of 8 frontend embeddings and 56
tokens.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch.convert import params_from_jax
from repro_torch.models import layers as L
from repro_torch.models.transformer import Attention, Transformer
from test_torch_hybrid import (
    CACHE_TOL, LOGIT_TOL, _close, _configs, _exact, _row_ulps,
    _states_close,
)

B, F, S_MAX, STEPS = 2, 8, 128, 4


def _pair(arch, dtype, seed=1):
    jc, pc = _configs(arch, dtype)
    params = JT.init_params(jc, jax.random.key(seed))
    model = Transformer(pc, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return jc, pc, params, model


def _near(got, want, dtype):
    if dtype == "float32":
        _close(got, want, 1e-5)
    else:
        assert _row_ulps(got, want) <= 1.0


def _inputs(jc, n_tok, n_fe, seed=7):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, jc.vocab, (B, n_tok)).astype(np.int32)
    fe = rng.standard_normal((B, n_fe, jc.frontend_dim or jc.d_model)
                             ).astype(np.float32)
    return toks, fe


# ---------------------------------------------------------------- modules
@pytest.mark.parametrize("parts", ["both", "frontend", "tokens"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embed_inputs_match_jax(dtype, parts):
    """JAX's ``_embed_inputs``: the projected frontend embeddings first,
    then the token embeddings; either may be absent."""
    jc, pc, params, model = _pair("qwen2_vl_72b", dtype)
    toks, fe = _inputs(jc, 12, F)
    batch = {}
    if parts != "tokens":
        batch["frontend_embeds"] = jnp.asarray(fe)
    if parts != "frontend":
        batch["tokens"] = jnp.asarray(toks)
    want, positions = JT._embed_inputs(params, batch, jc)
    got = model._embed(torch.from_numpy(toks) if "tokens" in batch else None,
                       torch.from_numpy(fe) if "frontend_embeds" in batch
                       else None)
    assert got.dtype == getattr(torch, dtype)
    assert got.shape == want.shape
    _near(got, want, dtype)
    assert np.array_equal(np.asarray(positions[0]), np.arange(want.shape[1]))


def test_embed_inputs_refuse_what_jax_would_drop():
    _, pc = _configs("gemma2_27b", "float32")
    model = Transformer(pc, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="no frontend"):
        model.prefill(torch.zeros((B, 8), dtype=torch.int32),
                      frontend_embeds=torch.zeros((B, 2, 128)))
    with pytest.raises(ValueError, match="needs tokens"):
        model.prefill()


@pytest.mark.parametrize("sections", [None, (4, 6, 6)])
def test_mrope_sections_match_jax(rng, sections):
    """With one position stream the M-RoPE sections rotate exactly as 1-D
    RoPE, in both packages; sections that do not cover D / 2 raise."""
    x = rng.standard_normal((2, 24, 3, 32)).astype(np.float32)
    pos = np.broadcast_to(np.arange(24, dtype=np.int32) + 7, (2, 24)).copy()
    got = L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6,
                       sections)
    _close(got, JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6,
                              sections), 1e-5)
    assert torch.equal(got, L.apply_rope(torch.from_numpy(x),
                                         torch.from_numpy(pos), 1e6))
    with pytest.raises(ValueError, match="M-RoPE"):
        L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6,
                     (4, 6, 5))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder_attention_matches_jax(rng, dtype):
    """The ``enc`` mixer's prefill (bidirectional flash attention) and the
    caches it fills, against JAX's ``_mixer_prefill``; a change to the
    last input moves the first output (no causal mask)."""
    jc, pc = _configs("hubert_xlarge", dtype)
    jp = JL.attn_params(jc, jax.random.key(2))
    p = Attention(pc, getattr(torch, dtype), "cpu", None)
    p.load_state_dict({k: torch.from_numpy(np.array(v))
                       for k, v in jp.items()})
    s = 64
    x = rng.standard_normal((B, s, jc.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (B, s)).copy()
    want, wst = JT._mixer_prefill(jnp.asarray(x, dtype), jp, jc, "enc",
                                  jnp.asarray(pos), S_MAX,
                                  jnp.dtype(dtype))
    shape = (B, pc.n_kv_heads, S_MAX, pc.hd)
    kc, vc = (torch.zeros(shape, dtype=getattr(torch, dtype))
              for _ in range(2))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = L.attn_prefill(tx, p, pc, "enc", torch.from_numpy(pos), kc, vc)
    _near(got, want, dtype)
    _near(kc, wst["k"], dtype)
    _near(vc, wst["v"], dtype)
    tx2 = tx.clone()
    tx2[:, -1] += 1
    again = L.attn_prefill(tx2, p, pc, "enc", torch.from_numpy(pos),
                           kc.clone(), vc.clone())
    assert not torch.equal(again[:, 0], got[:, 0])


# ------------------------------------------------------------ whole model
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hubert_encoder_prefill(dtype):
    """HuBERT-xlarge reduced: audio-stub embeddings only, no tokens, two
    encoder layers; logits and each layer's caches."""
    jc, pc, params, model = _pair("hubert_xlarge", dtype)
    _, fe = _inputs(jc, 0, 64)
    jl, jst = _exact(lambda p, e: JT.prefill(
        p, {"frontend_embeds": e}, jc, s_max=S_MAX), params,
        jnp.asarray(fe))(params, jnp.asarray(fe))
    pl, pst = model.prefill(frontend_embeds=torch.from_numpy(fe),
                            s_max=S_MAX)
    assert pl.shape == (B, jc.vocab) and pl.dtype == getattr(torch, dtype)
    _close(pl, jl, LOGIT_TOL[dtype])
    _states_close(jst, pst, jc, CACHE_TOL[dtype])
    assert pst.pos.tolist() == [64] * B


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qwen2_vl_prefill_and_teacher_forced_decode(dtype):
    """Qwen2-VL reduced: 8 vision-stub embeddings then 56 tokens, M-RoPE
    sections over positions 0..63; then teacher-forced decode steps from
    position 64."""
    jc, pc, params, model = _pair("qwen2_vl_72b", dtype)
    n = 64 - F
    toks, fe = _inputs(jc, n + STEPS, F)
    batch = (jnp.asarray(fe), jnp.asarray(toks[:, :n]))
    jl, jst = _exact(lambda p, e, t: JT.prefill(
        p, {"frontend_embeds": e, "tokens": t}, jc, s_max=S_MAX), params,
        *batch)(params, *batch)
    pl, pst = model.prefill(torch.from_numpy(toks[:, :n]), s_max=S_MAX,
                            frontend_embeds=torch.from_numpy(fe))
    _close(pl, jl, LOGIT_TOL[dtype])
    _states_close(jst, pst, jc, CACHE_TOL[dtype])
    step = _exact(lambda p, st, t: JT.decode_step(p, st, t, jc), params,
                  jst, jnp.asarray(toks[:, n]))
    for t in range(STEPS):
        jl, jst = step(params, jst, jnp.asarray(toks[:, n + t]))
        pl, pst = model.decode_step(pst, torch.from_numpy(toks[:, n + t]))
        _close(pl, jl, LOGIT_TOL[dtype])
    _states_close(jst, pst, jc, CACHE_TOL[dtype])
    assert pst.pos.tolist() == [64 + STEPS] * B


@pytest.mark.parametrize("arch", ["hubert_xlarge", "qwen2_vl_72b"])
def test_state_dict_covers_the_jax_tree(arch):
    """``frontend_proj`` (frontend_dim, d) comes across with the rest; it
    is stored in the compute dtype."""
    jc, pc = _configs(arch, "bfloat16")
    tree = jax.tree.map(np.asarray, JT.init_params(jc, jax.random.key(0)))
    model = Transformer(pc, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    sd = model.state_dict()
    assert set(params_from_jax(tree)) == set(sd)
    assert sd["frontend_proj"].shape == (pc.frontend_dim, pc.d_model)
    assert sd["frontend_proj"].dtype == torch.bfloat16


def test_launcher_refuses_an_encoder_and_serves_qwen2_vl(capsys):
    from repro_torch.launch import serve
    with pytest.raises(SystemExit, match="encoder-only"):
        serve.main(["--arch", "hubert-xlarge", "--reduced", "--device",
                    "cpu"])
    serve.main(["--arch", "qwen2-vl-72b", "--reduced", "--device", "cpu",
                "--batch", "2", "--new-tokens", "3"])
    out = capsys.readouterr().out.splitlines()
    assert len([ln for ln in out if ln.startswith("seq")]) == 2

"""The port's multi-head latent attention (``repro_torch.models.layers``
``MLA``) and DeepSeek-V2 against the JAX package's, with the reduced
``deepseek_v2_236b`` config (a dense prefix layer, then MLA + MoE layers
with a shared expert) and the JAX weights carried across.

Modules, against JAX run op by op.  float32: 1e-5.  bfloat16: the prefill's
output and caches and each decode flavour's output within one bf16 ulp of
their row's largest value (measured: one of 16,384 cache values one ulp
apart, the rest equal; each side rounds a float32 accumulation once).

The split.  JAX's decode step computes two MLA functions in bfloat16: its
prefix layers go through ``mla_decode`` (float32 softmax weights times the
cache upcast to float32), its scanned pattern layers through
``mla_decode_stacked`` (the weights rounded to the cache dtype first).  On
these inputs they differ in about half of the bf16 outputs.  The port
computes each where JAX does (``ctx_f32``: True in a prefix layer), and
the test pins it: each port flavour differs from its own JAX flavour in at
most 1% of the outputs (measured none) and from the other in over 20%.

The whole model: a prefill of 64 tokens and 4 teacher-forced decode steps
against JAX compiled with ``allow_excess_precision`` off, routes followed
at near ties, logits and every layer's ``ckv`` / ``kr`` cache at
``tests/test_torch_hybrid.py``'s tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.models import layers as JL
from repro.models import mlp as JM
from repro.models import transformer as JT
from repro_torch.convert import params_from_jax
from repro_torch.models import layers as L
from repro_torch.models import mlp as PM
from repro_torch.models.transformer import Transformer
from test_torch_hybrid import (
    CACHE_TOL, LOGIT_TOL, MAX_SET_ASIDE, _close, _configs, _exact, _np,
    _Routes, _row_ulps, _states_close,
)

ARCH = "deepseek_v2_236b"
B, S, S_MAX, STEPS = 2, 64, 128, 4
POS = np.asarray([40, 63], np.int32)           # decode positions, per row


def _mla_pair(dtype):
    jc, pc = _configs(ARCH, dtype)
    jp = JL.mla_params(jc, jax.random.key(3))
    p = L.MLA(pc, getattr(torch, dtype), "cpu", None)
    p.load_state_dict({k: torch.from_numpy(np.array(v))
                       for k, v in jp.items()})
    return jc, pc, jp, p


def _prefilled(dtype, rng):
    """(jc, pc, jp, p, the JAX caches, the port's) after a prefill of S
    random inputs into caches of S_MAX rows."""
    jc, pc, jp, p = _mla_pair(dtype)
    tdt = getattr(torch, dtype)
    x = rng.standard_normal((B, S, jc.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    ckv = torch.zeros((B, S_MAX, jc.kv_lora_rank), dtype=tdt)
    kr = torch.zeros((B, S_MAX, jc.qk_rope_dim), dtype=tdt)
    L.mla_prefill(torch.from_numpy(x).to(tdt), p, pc, torch.from_numpy(pos),
                  ckv, kr)
    jcache = {"ckv": jnp.asarray(_np(ckv), dtype),
              "kr": jnp.asarray(_np(kr), dtype)}
    return jc, pc, jp, p, jcache, (ckv, kr)


# ---------------------------------------------------------------- modules
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_prefill_matches_jax(rng, dtype):
    """The decompressed prefill (qk width nope + rope = 24, v width 16
    through flash attention) and the ckv / k_rope it writes."""
    jc, pc, jp, p = _mla_pair(dtype)
    tdt = getattr(torch, dtype)
    x = rng.standard_normal((B, S, jc.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    jx = jnp.asarray(x, dtype)
    want = JL.mla_train(jx, jp, jc, jnp.asarray(pos))
    jckv, jkr = JL._mla_ckv(jx, jp, jc, jnp.asarray(pos))
    ckv = torch.zeros((B, S_MAX, jc.kv_lora_rank), dtype=tdt)
    kr = torch.zeros((B, S_MAX, jc.qk_rope_dim), dtype=tdt)
    got = L.mla_prefill(torch.from_numpy(x).to(tdt), p, pc,
                        torch.from_numpy(pos), ckv, kr)
    assert got.dtype == tdt
    for a, b in ((got, want), (ckv[:, :S], jckv), (kr[:, :S], jkr)):
        if dtype == "float32":
            _close(a, b, 1e-5)
        else:
            assert _row_ulps(a, b) <= 1.0
    assert not ckv[:, S:].any() and not kr[:, S:].any()


@pytest.mark.parametrize("flavour", ["prefix", "stacked"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_decode_matches_jax(rng, dtype, flavour):
    """The absorbed decode at two positions per batch (40 and 63, over a
    prefilled cache): the output and the cache rows it writes in place,
    against ``mla_decode`` (prefix) or ``mla_decode_stacked`` (a stack of
    one layer)."""
    jc, pc, jp, p, jcache, (ckv, kr) = _prefilled(dtype, rng)
    tdt = getattr(torch, dtype)
    xt = rng.standard_normal((B, jc.d_model)).astype(np.float32)
    jx, jpos = jnp.asarray(xt, dtype), jnp.asarray(POS)
    if flavour == "prefix":
        want, jst = JL.mla_decode(jx, jp, jc, jcache, jpos)
        wckv, wkr = jst["ckv"], jst["kr"]
    else:
        want, wckv, wkr = JL.mla_decode_stacked(
            jx, jp, jc, jcache["ckv"][:, None], jcache["kr"][:, None], 0,
            jpos)
        wckv, wkr = wckv[:, 0], wkr[:, 0]
    got = L.mla_decode(torch.from_numpy(xt).to(tdt), p, pc, ckv, kr,
                       torch.from_numpy(POS),
                       ctx_f32=flavour == "prefix")
    assert got.dtype == tdt
    if dtype == "float32":
        _close(got, want, 1e-5)
    else:
        assert _row_ulps(got, want) <= 1.0
    _close(ckv, wckv, 1e-5)
    _close(kr, wkr, 1e-5)


def test_mla_bf16_split_follows_each_jax_flavour(rng):
    """See the module docstring: in bfloat16 JAX's two MLA decode functions
    differ, and each port flavour computes its own."""
    jc, pc, jp, p, jcache, (ckv, kr) = _prefilled("bfloat16", rng)
    xt = rng.standard_normal((B, jc.d_model)).astype(np.float32)
    jx, jpos = jnp.asarray(xt, jnp.bfloat16), jnp.asarray(POS)
    j_prefix = _np(JL.mla_decode(jx, jp, jc, jcache, jpos)[0])
    j_stacked = _np(JL.mla_decode_stacked(
        jx, jp, jc, jcache["ckv"][:, None], jcache["kr"][:, None], 0,
        jpos)[0])
    p_prefix, p_stacked = (_np(L.mla_decode(
        torch.from_numpy(xt).bfloat16(), p, pc, ckv, kr,
        torch.from_numpy(POS), ctx_f32=f)) for f in (True, False))
    assert (j_prefix != j_stacked).mean() > 0.2
    assert (p_prefix != j_prefix).mean() <= 0.01
    assert (p_stacked != j_stacked).mean() <= 0.01
    assert (p_prefix != j_stacked).mean() > 0.2
    assert (p_stacked != j_prefix).mean() > 0.2


@pytest.mark.parametrize("ctx_f32", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_absorbed_matches_decompressed(rng, dtype, ctx_f32):
    """The absorbed attention against keys and values decompressed per
    head in float32 from the same caches (the check ``chip_smoke.py``
    phase 13 runs at full width): float32 within 1e-5 of each head's
    largest output, bfloat16 within 2^-6 of it (measured 0.0042)."""
    jc, pc, jp, p, _, (ckv, kr) = _prefilled(dtype, rng)
    tdt = getattr(torch, dtype)
    x = torch.from_numpy(rng.standard_normal((B, 1, jc.d_model)).astype(
        np.float32)).to(tdt)
    pos = torch.from_numpy(POS)
    q_nope, q_rope = L._mla_q(x, p, pc, pos[:, None])
    args = (q_nope[:, 0], q_rope[:, 0], ckv, kr, pos + 1, p, pc)
    got = L.mla_attend_absorbed(*args, ctx_f32=ctx_f32)
    want = L.mla_attend_decompressed(*args)
    assert got.dtype == tdt and want.dtype == torch.float32
    top = want.abs().amax(dim=-1, keepdim=True)
    err = float(((got.float() - want).abs() / top).max())
    assert err <= (1e-5 if dtype == "float32" else 2.0 ** -6)


# ------------------------------------------------------------ whole model
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_teacher_forced_decode(dtype, monkeypatch):
    """DeepSeek-V2 reduced: the dense prefix layer (``dense_d_ff``) and the
    MLA + MoE pattern layers, a prefill then teacher-forced decode steps;
    the prefix layer's MLA decode is JAX's ``mla_decode``, the pattern
    layers' its ``mla_decode_stacked``."""
    jc, pc = _configs(ARCH, dtype)
    params = JT.init_params(jc, jax.random.key(1))
    model = Transformer(pc, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    assert [b.prefix for b in model.layers] == [True, False, False]
    routes = _Routes()
    monkeypatch.setattr(JM, "moe", routes.jax_moe(JM.moe))
    monkeypatch.setattr(PM, "top_k", routes.port_top_k(PM.top_k))
    toks = np.random.default_rng(7).integers(
        0, jc.vocab, (B, S + STEPS)).astype(np.int32)
    words = np.full((B, 1), -1, np.uint32)     # no layer reads them
    old = jops._DEFAULT
    jops.set_default_backend("pallas")
    try:
        prompt = jnp.asarray(toks[:, :S])
        jl, jst = _exact(lambda p, t: JT.prefill(
            p, {"tokens": t}, jc, s_max=S_MAX), params, prompt)(params,
                                                                prompt)
        jax.effects_barrier()
        pl, pst = model.prefill(torch.from_numpy(toks[:, :S]), s_max=S_MAX)
        _close(pl, jl, LOGIT_TOL[dtype])
        _states_close(jst, pst, jc, CACHE_TOL[dtype])
        step = _exact(lambda p, st, t, m: JT.decode_step(p, st, t, jc, m),
                      params, jst, jnp.asarray(toks[:, S]),
                      jnp.asarray(words))
        for t in range(STEPS):
            jl, jst = step(params, jst, jnp.asarray(toks[:, S + t]),
                           jnp.asarray(words))
            jax.effects_barrier()
            pl, pst = model.decode_step(
                pst, torch.from_numpy(toks[:, S + t]),
                torch.from_numpy(words.view(np.int32)))
            _close(pl, jl, LOGIT_TOL[dtype])
            _states_close(jst, pst, jc, CACHE_TOL[dtype])
        assert pst.pos.tolist() == [S + STEPS] * B
    finally:
        jops.set_default_backend(old)
    assert routes.calls == 2 * (1 + STEPS)
    assert not routes.far, f"routes differ past a near tie: {routes.far}"
    assert len(routes.aside) <= MAX_SET_ASIDE


def test_state_dict_and_widths():
    """Every key comes from the JAX tree and back; the prefix layer's MLP
    is ``dense_d_ff`` wide and the experts ``moe_d_ff``; the MLA norm
    scales stay float32."""
    jc, pc = _configs(ARCH, "bfloat16")
    tree = jax.tree.map(np.asarray, JT.init_params(jc, jax.random.key(0)))
    model = Transformer(pc, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    sd = model.state_dict()
    assert set(params_from_jax(tree)) == set(sd)
    assert sd["layers.0.ffn.w_gate"].shape == (pc.d_model, pc.dense_d_ff)
    assert sd["layers.1.ffn.wg"].shape == (pc.n_experts, pc.d_model,
                                           pc.moe_d_ff)
    assert sd["layers.1.mixer.w_uk"].shape == (
        pc.kv_lora_rank, pc.n_heads, pc.qk_nope_dim)
    for key, t in sd.items():
        f32 = key.endswith(("router", "scale", "q_ln", "kv_ln"))
        assert t.dtype == (torch.float32 if f32 else torch.bfloat16), key


def test_decode_step_reruns_from_the_same_state():
    """The step writes its ckv / kr rows in place before reading them, so a
    second step from the same state gives the same logits and shares the
    caches."""
    _, pc = _configs(ARCH, "float32")
    model = Transformer(pc, device="cpu",
                        generator=torch.Generator().manual_seed(3))
    toks = torch.from_numpy(np.random.default_rng(8).integers(
        0, pc.vocab, (B, S + 1)).astype(np.int32))
    _, st = model.prefill(toks[:, :S], s_max=S_MAX)
    a, st1 = model.decode_step(st, toks[:, S])
    b, st2 = model.decode_step(st, toks[:, S])
    assert torch.equal(a, b)
    assert all(x is y is z for x, y, z in zip(st.layers, st1.layers,
                                              st2.layers, strict=True))
    assert st1.pos.tolist() == [S + 1] * B


def test_launcher_serves_the_reduced_config(capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", "deepseek-v2-236b", "--reduced", "--device", "cpu",
                "--batch", "2", "--new-tokens", "3"])
    out = capsys.readouterr().out.splitlines()
    assert len([ln for ln in out if ln.startswith("seq")]) == 2

"""The port's hybrid and MoE models against the JAX package's: reduced
``jamba_v01_52b`` (7 mamba layers and one global layer a period, MoE in
every other layer) and reduced ``mixtral_8x7b`` (local attention + MoE),
in float32 and bfloat16, with the JAX weights carried across by
``convert.params_from_jax``; which blocks ``check_supported`` accepts; the
decode state's layout and its reuse.

The whole-model test is ``tests/test_torch_model.py``'s
``test_prefill_and_teacher_forced_decode`` scheme: a prefill of 256 tokens
(a multiple of ``ssm_chunk``, which JAX asserts), then 8 teacher-forced
decode steps with the Roaring mask words; after every step the logits,
each attention layer's K and V caches and each mamba layer's ``h`` and
``conv``, at that file's tolerances (float32: 1e-4 on logits, 1e-5 on
states; bfloat16: 0.125 and 0.0625).  The JAX side runs under
``set_default_backend("pallas")``, its prefill and decode step compiled
with XLA's ``allow_excess_precision`` off.  That option, on by default,
lets XLA keep a bfloat16 sum in float32 where a float32 op reads it next
(``rms_norm(x + h)``): JAX's jitted block then differs from its own
op-by-op run in half of the bfloat16 elements, and over Jamba's eight
recurrent layers that drift reached 1.36 times these tolerances.  With it
off, JAX rounds where its program's dtypes say, as the port does, and the
largest difference is 0.65 of the tolerance.

Routes.  In bfloat16 a one-ulp difference in a hidden state can move a
token's router probabilities across a near tie, and the token then goes
to another expert: its output, and every later token through attention
and the mamba state, differ by far more than rounding.  So JAX's routing
is recorded call by call (a ``jax.debug.callback`` on its MoE layers), and
where the port's top-k set differs the test reads JAX's own probabilities
of the flipped pair.  Within ``NEAR_TIE`` (0.005) the token is set aside
from the routing check and routed as JAX routes it, so that the rest of
the run stays comparable; any other difference fails, and so do more than
``MAX_SET_ASIDE`` (16) tokens set aside in a run.  Measured: 6 of 2,112
routed tokens for Jamba in bfloat16, at gaps up to 0.0017; none for
Mixtral, none in float32.  The count is printed.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
from repro.kernels import ops as jops
from repro.models import mlp as JM
from repro.models import transformer as JT
from repro_torch import configs as C
from repro_torch.convert import params_from_jax
from repro_torch.models import mlp as PM
from repro_torch.models.transformer import Transformer, check_supported

B, S, S_MAX, STEPS = 2, 256, 512, 8
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 0.125}
CACHE_TOL = {"float32": 1e-5, "bfloat16": 0.0625}
NEAR_TIE = 0.005
MAX_SET_ASIDE = 16
ARCHS = ("jamba_v01_52b", "mixtral_8x7b")


def _configs(arch, dtype, **kw):
    jc = JC.get_config(arch, reduced=True)
    pc = C.get_config(arch, reduced=True)
    return (dataclasses.replace(jc, compute_dtype=dtype, **kw),
            dataclasses.replace(pc, compute_dtype=dtype, **kw))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def _row_ulps(got, want):
    """The largest |got - want| over one bf16 ulp of the largest |want| of
    its row (the last axis)."""
    g, w = _np(got), _np(want)
    top = np.maximum(np.abs(w).max(axis=-1, keepdims=True), 2.0 ** -126)
    return float((np.abs(g - w) / 2.0 ** (np.floor(np.log2(top)) - 7)).max())


class _Routes:
    """JAX's routing, recorded call by call, and the port's top-k made to
    follow it where JAX's probabilities of the flipped pair nearly tie."""

    def __init__(self):
        self.jax, self.calls, self.routed = [], 0, 0
        self.aside, self.far = [], []

    def _record(self, idx, probs):
        self.jax.append((np.array(idx).reshape(-1, idx.shape[-1]),
                         np.asarray(probs)))

    def jax_moe(self, moe):
        def recorded(x, p, cfg):
            y, metrics = moe(x, p, cfg)
            x2 = x.reshape(-1, x.shape[-1]).astype(jnp.float32)
            probs = jax.nn.softmax(x2 @ p["router"].astype(jnp.float32),
                                   axis=-1)
            jax.debug.callback(self._record, metrics["expert_idx"], probs,
                               ordered=True)
            return y, metrics
        return recorded

    def port_top_k(self, top_k):
        def following(probs, k):
            vals, idx = top_k(probs, k)
            jidx, jprobs = self.jax[self.calls]
            assert jidx.shape == tuple(idx.shape)
            for t in range(len(jidx)):
                mine, theirs = set(idx[t].tolist()), set(jidx[t].tolist())
                if mine == theirs:
                    continue
                gap = max(abs(float(jprobs[t, a] - jprobs[t, b]))
                          for a in theirs - mine for b in mine - theirs)
                (self.aside if gap <= NEAR_TIE else self.far).append(
                    (self.calls, t, gap))
                idx[t] = torch.as_tensor(jidx[t], dtype=idx.dtype)
                vals[t] = probs[t, idx[t]]
            self.calls += 1
            self.routed += len(jidx)
            return vals, idx
        return following


def _exact(fn, *args):
    """``fn`` compiled for ``args`` as ``jax.jit`` compiles it, but with
    XLA's ``allow_excess_precision`` off, so that every bfloat16 op rounds
    as the program's dtypes say (see the module docstring)."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})


def _jax_layer_state(jst, jc, i):
    """Layer i's decode state in JAX's tree: ``prefix_<i>``, or repeat r of
    pattern position pi (batch-major stacks)."""
    n_prefix = len(jc.prefix)
    if i < n_prefix:
        return jst[f"prefix_{i}"]
    r, pi = divmod(i - n_prefix, len(jc.pattern))
    return {k: v[:, r] for k, v in jst["pattern"][pi].items()}


def _states_close(jst, pst, jc, tol):
    """Every layer's state, key by key (attention ``k``/``v``, MLA
    ``ckv``/``kr``, mamba ``conv``/``h``, mLSTM ``C``/``n``/``m``, sLSTM
    ``c``/``n``/``h``/``m``); the recurrent states are float32."""
    for i, (mixer, _) in enumerate(jc.layer_kinds):
        js = _jax_layer_state(jst, jc, i)
        ps = pst.layers[i]
        assert set(ps) == set(js), (mixer, set(ps), set(js))
        for key, want in js.items():
            if mixer in ("mamba", "mlstm", "slstm") and key != "conv":
                assert ps[key].dtype == torch.float32
            _close(ps[key], want, tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_teacher_forced_decode(arch, dtype, monkeypatch):
    jc, pc = _configs(arch, dtype)
    check_supported(pc)
    params = JT.init_params(jc, jax.random.key(1))
    model = Transformer(pc, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    routes = _Routes()
    monkeypatch.setattr(JM, "moe", routes.jax_moe(JM.moe))
    monkeypatch.setattr(PM, "top_k", routes.port_top_k(PM.top_k))
    toks = np.random.default_rng(7).integers(
        0, jc.vocab, (B, S + STEPS)).astype(np.int32)
    # blocks 0 and 2 visible (the prompt's first block and the decoded
    # tokens), the prompt's second block hidden, block 3 set past every
    # kv_len
    jwords = np.full((B, 1), 0b1101, np.uint32)
    twords = torch.from_numpy(jwords.view(np.int32))
    old = jops._DEFAULT
    jops.set_default_backend("pallas")
    try:
        prompt = jnp.asarray(toks[:, :S])
        jl, jst = _exact(lambda p, t: JT.prefill(
            p, {"tokens": t}, jc, s_max=S_MAX), params, prompt)(params,
                                                                prompt)
        jax.effects_barrier()
        pl, pst = model.prefill(torch.from_numpy(toks[:, :S]), s_max=S_MAX)
        assert pl.dtype == getattr(torch, dtype)
        _close(pl, jl, LOGIT_TOL[dtype])
        _states_close(jst, pst, jc, CACHE_TOL[dtype])
        step = _exact(lambda p, st, t, m: JT.decode_step(p, st, t, jc, m),
                      params, jst, jnp.asarray(toks[:, S]),
                      jnp.asarray(jwords))
        for t in range(STEPS):
            jl, jst = step(params, jst, jnp.asarray(toks[:, S + t]),
                           jnp.asarray(jwords))
            jax.effects_barrier()
            pl, pst = model.decode_step(pst, torch.from_numpy(toks[:, S + t]),
                                        twords)
            _close(pl, jl, LOGIT_TOL[dtype])
            _states_close(jst, pst, jc, CACHE_TOL[dtype])
        assert pst.pos.tolist() == [S + STEPS] * B
    finally:
        jops.set_default_backend(old)
    n_moe = sum(f == "moe" for _, f in jc.layer_kinds)
    assert routes.calls == len(routes.jax) == n_moe * (1 + STEPS)
    print(f"{arch} {dtype}: {len(routes.aside)} of {routes.routed} routed "
          f"tokens set aside at a near tie (gaps up to "
          f"{max((g for *_, g in routes.aside), default=0):.3g})")
    assert not routes.far, f"routes differ past a near tie: {routes.far}"
    assert len(routes.aside) <= MAX_SET_ASIDE


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_reruns_from_the_same_state(arch):
    """A step writes its attention columns before reading and returns new
    mamba tensors, so a second step from the same state (the plain decode
    attention forced) gives the same logits and leaves the state as it
    was."""
    _, pc = _configs(arch, "float32")
    model = Transformer(pc, device="cpu",
                        generator=torch.Generator().manual_seed(3))
    toks = torch.from_numpy(np.random.default_rng(8).integers(
        0, pc.vocab, (B, S + 1)).astype(np.int32))
    _, st = model.prefill(toks[:, :S], s_max=S_MAX)
    h0 = [ls["h"].clone() if "conv" in ls else None for ls in st.layers]
    words = torch.full((B, 1), 0b111, dtype=torch.int32)
    a, st1 = model.decode_step(st, toks[:, S], words)
    b, st2 = model.decode_step(st, toks[:, S], words, backend="ref")
    assert torch.equal(a, b)
    for i, h in enumerate(h0):
        if h is not None:
            assert torch.equal(st.layers[i]["h"], h)
            assert torch.equal(st1.layers[i]["h"], st2.layers[i]["h"])
            assert not torch.equal(st1.layers[i]["h"], h)
        else:
            assert st1.layers[i] is st2.layers[i] is st.layers[i]
    assert st.pos.tolist() == [S] * B and st1.pos.tolist() == [S + 1] * B


@pytest.mark.parametrize("shared", [0, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_state_dict_covers_the_jax_tree(arch, shared):
    """Every key of the port's state dict comes from the JAX tree and
    back, shared experts' nested dict included; the router and ``A_log``
    stay float32, the rest is stored in the compute dtype."""
    jc, pc = _configs(arch, "bfloat16", n_shared_experts=shared)
    tree = jax.tree.map(np.asarray, JT.init_params(jc, jax.random.key(0)))
    model = Transformer(pc, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    sd = model.state_dict()
    assert set(params_from_jax(tree)) == set(sd)
    assert any(".ffn.shared.w_gate" in k for k in sd) == bool(shared)
    for key, t in sd.items():
        f32 = key.endswith(("router", "A_log", "scale", "norm"))
        assert t.dtype == (torch.float32 if f32 else torch.bfloat16), key


def test_check_supported_accepts_jamba_and_mixtral():
    for arch in ARCHS:
        for reduced in (True, False):
            check_supported(C.get_config(arch, reduced=reduced))


@pytest.mark.parametrize("reduced", [True, False])
@pytest.mark.parametrize("arch", C.ARCH_IDS)
def test_check_supported_accepts_every_config(arch, reduced):
    check_supported(C.get_config(arch, reduced=reduced))


@pytest.mark.parametrize("arch,kw", [
    ("deepseek_v2_236b", {}),                               # mla
    ("hubert_xlarge", {}),                                  # enc, audio
    ("xlstm_350m", {}),                                     # mlstm, slstm
    ("qwen2_vl_72b", {}),                                   # vision frontend
    ("jamba_v01_52b", dict(pattern=(("mamba", "none"),))),  # ffn none
    ("jamba_v01_52b", dict(pattern=(("mlstm", "moe"),))),
    ("jamba_v01_52b", dict(pattern=(("slstm", "mlp"),))),
    # MLA needs its low-rank widths, which mixtral does not set
    ("mixtral_8x7b", dict(pattern=(("mla", "moe"),), q_lora_rank=48,
                          kv_lora_rank=32)),
    ("mixtral_8x7b", dict(pattern=(("enc", "moe"),))),
    ("mixtral_8x7b", dict(frontend="vision_stub")),
    ("mixtral_8x7b", dict(frontend="audio_stub")),
])
def test_every_block_and_frontend_runs(arch, kw):
    """Each combination the port once refused now builds and runs a
    prefill (frontend embeddings first where there is a frontend) and one
    decode step on the CPU: finite logits of the right shape, every layer's
    state under JAX's keys."""
    cfg = dataclasses.replace(C.get_config(arch, reduced=True), **kw)
    check_supported(cfg)
    model = Transformer(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(2))
    rng = np.random.default_rng(5)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (B, 65))
                            .astype(np.int32))
    fe = None
    if cfg.frontend != "none":
        fe = torch.from_numpy(rng.standard_normal(
            (B, 8, cfg.frontend_dim or cfg.d_model)).astype(np.float32))
    n = 64 - (8 if fe is not None else 0)
    logits, st = model.prefill(toks[:, :n], s_max=128, frontend_embeds=fe)
    assert logits.shape == (B, cfg.vocab) and torch.isfinite(logits).all()
    assert st.pos.tolist() == [64] * B
    words = torch.full((B, 1), -1, dtype=torch.int32)
    logits, st = model.decode_step(st, toks[:, n], words)
    assert logits.shape == (B, cfg.vocab) and torch.isfinite(logits).all()
    assert st.pos.tolist() == [65] * B
    keys = {"mla": {"ckv", "kr"}, "mamba": {"conv", "h"},
            "mlstm": {"C", "n", "m"}, "slstm": {"c", "n", "h", "m"}}
    for (mixer, _), ls in zip(cfg.layer_kinds, st.layers, strict=True):
        assert set(ls) == keys.get(mixer, {"k", "v"})


def test_check_supported_refuses_what_jax_cannot_build():
    """An mla layer without its low-rank widths (JAX's init divides by
    them) and a frontend the JAX package does not know."""
    mla = dataclasses.replace(C.get_config("mixtral_8x7b", reduced=True),
                              pattern=(("mla", "moe"),))
    with pytest.raises(ValueError, match="q_lora_rank"):
        check_supported(mla)
    with pytest.raises(ValueError, match="q_lora_rank"):
        Transformer(mla, device="cpu")
    video = dataclasses.replace(C.get_config("qwen2_vl_72b", reduced=True),
                                frontend="video_stub")
    with pytest.raises(NotImplementedError, match="video_stub"):
        check_supported(video)


@pytest.mark.parametrize("arch", ARCHS)
def test_the_model_needs_a_gpu_by_default(arch):
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a GPU")
    with pytest.raises(RuntimeError, match="CUDA"):
        Transformer(C.get_config(arch, reduced=True))


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "mixtral-8x7b"])
def test_launcher_serves_the_reduced_config(arch, capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                "--batch", "2", "--new-tokens", "4"])
    out = capsys.readouterr().out.splitlines()
    rows = [line for line in out if line.startswith("seq")]
    assert len(rows) == 2 and out[-1].startswith("paged KV pages used")

"""The port's serving model (``repro_torch.models``) against the JAX
package's, module by module and as a whole, with the reduced gemma2 config
(``gemma2_27b.reduced()``: local + global layers, softcaps, post-norms, a
scaled and tied embedding, GeGLU) and the JAX weights carried across by
``convert.params_from_jax``.  The JAX side runs under
``set_default_backend("pallas")``, so its global layers take the Pallas
decode kernel in interpret mode.

Tolerances.  Float32 compute: 1e-4 on logits (measured about 4e-6: the
packages differ only in summation order and an ulp of cos, sin and rsqrt);
1e-5 for the single modules.  bfloat16 compute: 0.125 on logits and
0.0625 on the caches.  The port computes every op JAX computes, in the same
dtype (the tanh GeLU op for op with bf16 constants), but a bf16 matrix
product's float32 accumulation order differs between XLA and PyTorch, so
about 1% of the first layer's outputs land one bf16 ulp apart, and the
next layer's projections, summing 128 such inputs, round a quarter of
their outputs apart.  Each difference is one rounding, the size of bf16's
own error against float32 (the JAX package's bf16 logits differ from its
float32 logits by up to 0.051 on these inputs).  Logits reach about 6 and
cache values about 4.5, where one bf16 ulp is 0.03125; 4 and 2 ulps bound
them.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
from repro.kernels import ops as jops
from repro.models import layers as JL
from repro.models import mlp as JM
from repro.models import transformer as JT
from repro_torch import configs as C
from repro_torch.convert import params_from_jax
from repro_torch.models import layers as L
from repro_torch.models.mlp import gelu_tanh, mlp
from repro_torch.models.transformer import MLP, Transformer
from test_torch_hybrid import _exact

B, S, S_MAX, STEPS = 2, 192, 512, 8
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 0.125}
CACHE_TOL = {"float32": 1e-5, "bfloat16": 0.0625}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _configs(dtype, **kw):
    jc = dataclasses.replace(JC.get_config("gemma2_27b", reduced=True),
                             compute_dtype=dtype, **kw)
    pc = dataclasses.replace(C.get_config("gemma2_27b", reduced=True),
                             compute_dtype=dtype, **kw)
    return jc, pc


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


# ---------------------------------------------------------------- modules
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norms(rng, dtype):
    x = rng.standard_normal((2, 5, 48)).astype(np.float32)
    sc = rng.standard_normal(48).astype(np.float32) * 0.1
    bias = rng.standard_normal(48).astype(np.float32) * 0.1
    jx, tx = jnp.asarray(x, dtype), torch.from_numpy(x).to(
        getattr(torch, dtype))
    tol = 1e-5 if dtype == "float32" else 7.9e-3     # one bf16 ulp, relative
    _close(L.rms_norm(tx, torch.from_numpy(sc)),
           JL.rms_norm(jx, jnp.asarray(sc)), tol)
    _close(L.layer_norm(tx, torch.from_numpy(sc), torch.from_numpy(bias)),
           JL.layer_norm(jx, jnp.asarray(sc), jnp.asarray(bias)), tol)


def test_rope(rng):
    x = rng.standard_normal((2, 40, 3, 32)).astype(np.float32)
    pos = np.broadcast_to(np.arange(40, dtype=np.int32) + 100, (2, 40))
    got = L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos.copy()),
                       10000.0)
    _close(got, JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0),
           1e-5)


@pytest.mark.parametrize("causal,window,softcap,skip", [
    (True, 0, 0.0, False), (True, 0, 0.0, True), (True, 48, 0.0, True),
    (True, 48, 5.0, False), (False, 0, 5.0, False)])
def test_flash_attention(rng, causal, window, softcap, skip):
    q = rng.standard_normal((2, 128, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 128, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 128, 2, 16)).astype(np.float32)
    kw = dict(causal=causal, window=window, softcap=softcap, q_chunk=32,
              k_chunk=64, block_skip=skip)
    got = L.flash_attention(*map(torch.from_numpy, (q, k, v)), **kw)
    want = JL.flash_attention(*map(jnp.asarray, (q, k, v)), **kw)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("window,softcap", [(0, 0.0), (24, 0.0), (24, 7.0)])
def test_decode_attention_dense(rng, window, softcap):
    q = rng.standard_normal((3, 4, 16)).astype(np.float32)
    k = rng.standard_normal((3, 2, 64, 16)).astype(np.float32)
    v = rng.standard_normal((3, 2, 64, 16)).astype(np.float32)
    kvl = np.asarray([1, 30, 64], np.int32)
    got = L.decode_attention_dense(
        *map(torch.from_numpy, (q, k, v, kvl)), window=window,
        softcap=softcap)
    want = JL.decode_attention_dense(*map(jnp.asarray, (q, k, v, kvl)),
                                     window=window, softcap=softcap)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu"])
def test_mlp(rng, act):
    jc, pc = _configs("float32", act=act)
    jp = JM.mlp_params(jc, jax.random.key(3))
    p = MLP(pc, torch.float32, "cpu", None)
    p.load_state_dict({k: torch.from_numpy(np.array(v))
                       for k, v in jp.items()})
    x = rng.standard_normal((2, 3, jc.d_model)).astype(np.float32)
    _close(mlp(torch.from_numpy(x), p, pc), JM.mlp(jnp.asarray(x), jp, jc),
           1e-5)


def test_gelu_is_jax_gelu_in_bf16(rng):
    """The tanh GeLU op for op with bf16 constants equals jax.nn.gelu bit
    for bit in bfloat16 (``F.gelu`` differs in about 43% of elements)."""
    x = (rng.standard_normal(50_000) * 3).astype(np.float32)
    got = gelu_tanh(torch.from_numpy(x).bfloat16())
    want = jax.nn.gelu(jnp.asarray(x, jnp.bfloat16))
    assert np.array_equal(_np(got), _np(want))


# ------------------------------------------------------------ whole model
@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def pair(request):
    """(dtype, JAX config, JAX params, port config, port model) with the
    same weights."""
    jc, pc = _configs(request.param)
    params = JT.init_params(jc, jax.random.key(1))
    model = Transformer(pc, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return request.param, jc, params, pc, model


def _mask_words():
    """Blocks 0 and 1 visible (the prompt and the decoded tokens), block 3
    set past every kv_len."""
    words = np.full((B, 1), 0b1011, np.uint32)
    return words, torch.from_numpy(words.view(np.int32))


def test_prefill_and_teacher_forced_decode(pair):
    dtype, jc, params, pc, model = pair
    toks = np.random.default_rng(7).integers(
        0, jc.vocab, (B, S + STEPS)).astype(np.int32)
    old = jops._DEFAULT
    jops.set_default_backend("pallas")
    try:
        jl, jst = JT.prefill(params, {"tokens": jnp.asarray(toks[:, :S])},
                             jc, s_max=S_MAX)
        pl, pst = model.prefill(torch.from_numpy(toks[:, :S]), s_max=S_MAX)
        assert pl.dtype == getattr(torch, dtype)
        _close(pl, jl, LOGIT_TOL[dtype])
        n_pat = len(jc.pattern)
        for i in range(jc.n_layers):
            r, pi = divmod(i, n_pat)
            for name in ("k", "v"):
                _close(pst.layers[i][name], jst["pattern"][pi][name][:, r],
                       CACHE_TOL[dtype])
        assert pst.pos.tolist() == [S] * B
        jwords, twords = _mask_words()
        step = jax.jit(lambda p, st, t, m: JT.decode_step(p, st, t, jc, m))
        for t in range(STEPS):
            jl, jst = step(params, jst, jnp.asarray(toks[:, S + t]),
                           jnp.asarray(jwords))
            pl, pst = model.decode_step(pst, torch.from_numpy(toks[:, S + t]),
                                        twords)
            _close(pl, jl, LOGIT_TOL[dtype])
        assert pst.pos.tolist() == [S + STEPS] * B
    finally:
        jops.set_default_backend(old)


def test_decode_step_reruns_from_the_same_state(pair):
    """A step writes its own token column before reading, so a second step
    from the same state (here with the plain version forced) gives the
    same logits: what the chip check relies on to compare the kernel and
    the plain version at full size without copying the caches."""
    _, jc, _, _, model = pair
    toks = np.random.default_rng(8).integers(0, jc.vocab, (B, S + 1))
    _, st = model.prefill(torch.from_numpy(toks[:, :S]), s_max=S_MAX)
    _, words = _mask_words()
    tok = torch.from_numpy(toks[:, S])
    a, st1 = model.decode_step(st, tok, words)
    b, st2 = model.decode_step(st, tok, words, backend="ref")
    assert torch.equal(a, b)
    assert all(x is y for x, y in zip(st1.layers, st2.layers, strict=True))
    assert st.pos.tolist() == [S] * B and st1.pos.tolist() == [S + 1] * B


def test_random_init_is_seeded():
    _, pc = _configs("bfloat16")
    a = Transformer(pc, device="cpu",
                    generator=torch.Generator().manual_seed(5))
    b = Transformer(pc, device="cpu",
                    generator=torch.Generator().manual_seed(5))
    c = Transformer(pc, device="cpu",
                    generator=torch.Generator().manual_seed(6))
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["layers.1.mixer.wq"],
                           c.state_dict()["layers.1.mixer.wq"])
    assert sa["embed"].dtype == torch.bfloat16
    assert sa["layers.0.ln1.scale"].dtype == torch.float32
    # the state dict covers the JAX tree exactly
    jc, _ = _configs("bfloat16")
    tree = jax.tree.map(np.asarray, JT.init_params(jc, jax.random.key(0)))
    assert set(params_from_jax(tree)) == set(sa)


# ----------------------------------------------- the sparse_topk gather route
def _gather_inputs(rng, dtype, b=3, h=4, hkv=2, d=16, s=512, bs=32):
    """q, k, v, mask words and kv_len for 16 blocks of 32: row 0 sees
    blocks {0, 3, 5, 9} below kv_len 300, row 1 every block below kv_len
    512, row 2 none (only a block past its kv_len of 40 is set)."""
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    k = (rng.standard_normal((b, hkv, s, d)) * 0.3).astype(np.float32)
    v = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    words = np.asarray([[1 | 1 << 3 | 1 << 5 | 1 << 9 | 1 << 12],
                        [0xFFFF], [1 << 7]], np.uint32)
    kvl = np.asarray([300, 512, 40], np.int32)
    tdt = getattr(torch, dtype)
    jx = [jnp.asarray(a, dtype) for a in (q, k, v)]
    tx = [torch.from_numpy(a).to(tdt) for a in (q, k, v)]
    return (jx + [jnp.asarray(words), jnp.asarray(kvl)],
            tx + [torch.from_numpy(words.view(np.int32)),
                  torch.from_numpy(kvl)], bs)


@pytest.mark.parametrize("topk", [1, 3, 4, 16, 64])
def test_visible_block_ids_match_jax(rng, topk):
    """The first ``topk`` visible blocks of each row, ascending, by the
    prefix-sum rank; 0 past the count."""
    (*_, jw, jk), (*_, tw, tk), bs = _gather_inputs(rng, "float32")
    want_idx, want_n = JL.visible_block_ids(jw, jk, 16, bs, min(topk, 16))
    idx, n = L.visible_block_ids(tw, tk, 16, bs, min(topk, 16))
    assert np.array_equal(idx.numpy(), np.asarray(want_idx))
    assert np.array_equal(n.numpy(), np.asarray(want_n))


@pytest.mark.parametrize("softcap", [0.0, 5.0])
@pytest.mark.parametrize("topk", [2, 16])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_gather_matches_jax(rng, dtype, topk, softcap):
    """``decode_attention_block_gather`` against JAX's at g = 2, with
    fewer (topk 2) and at least as many (16) gathered blocks as visible
    ones and a row with none visible: float32 within 1e-5, bfloat16
    within one bf16 ulp of each row's largest output."""
    jx, tx, bs = _gather_inputs(rng, dtype)
    kw = dict(block_size=bs, topk=topk, softcap=softcap)
    want = JL.decode_attention_block_gather(*jx[:3], jx[4], jx[3], **kw)
    got = L.decode_attention_block_gather(*tx[:3], tx[4], tx[3], **kw)
    assert got.dtype == tx[0].dtype
    if dtype == "float32":
        _close(got, want, 1e-5)
    else:
        w, g = _np(want), _np(got)
        top = np.abs(w).max(axis=-1, keepdims=True)
        assert (np.abs(g - w) <= 2.0 ** (np.floor(np.log2(top)) - 7)).all()


def test_block_gather_against_row_17(rng):
    """With every visible block gathered, the route computes row 17's
    function in float32 (within summation order, 1e-5), except on a row
    with nothing visible (row 17 gives 0, the gather route a uniform
    average); with fewer gathered than visible it is another function."""
    from repro_torch.kernels import ref
    _, (q, k, v, words, kvl), bs = _gather_inputs(rng, "float32")
    row17 = ref.block_sparse_attention_decode(q, k, v, words, kvl,
                                              block_size=bs)
    full = L.decode_attention_block_gather(q, k, v, kvl, words,
                                           block_size=bs, topk=16)
    _close(full[:2], row17[:2], 1e-5)
    assert not row17[2].any() and full[2].abs().max() > 0
    cut = L.decode_attention_block_gather(q, k, v, kvl, words,
                                          block_size=bs, topk=2)
    assert (cut[:2] - row17[:2]).abs().max() > 1e-2


@pytest.mark.parametrize("topk", [1, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_route_decode_matches_jax(dtype, topk):
    """The reduced gemma2 model with ``sparse_topk_blocks``: its global
    layers' decode takes the gather route in both packages (JAX's scanned
    ``attn_decode_stacked``); with topk 1 only block 0 of the two visible
    counts.  Prefill, then 4 teacher-forced steps at this file's
    tolerances, JAX compiled with ``allow_excess_precision`` off (see
    ``tests/test_torch_hybrid.py``)."""
    jc, pc = _configs(dtype, sparse_topk_blocks=topk)
    params = JT.init_params(jc, jax.random.key(1))
    model = Transformer(pc, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    toks = np.random.default_rng(7).integers(
        0, jc.vocab, (B, S + 4)).astype(np.int32)
    jwords, twords = _mask_words()
    prompt = jnp.asarray(toks[:, :S])
    jl, jst = _exact(lambda p, t: JT.prefill(
        p, {"tokens": t}, jc, s_max=S_MAX), params, prompt)(params, prompt)
    _, pst = model.prefill(torch.from_numpy(toks[:, :S]), s_max=S_MAX)
    step = _exact(lambda p, st, t, m: JT.decode_step(p, st, t, jc, m),
                  params, jst, jnp.asarray(toks[:, S]), jnp.asarray(jwords))
    for t in range(4):
        jl, jst = step(params, jst, jnp.asarray(toks[:, S + t]),
                       jnp.asarray(jwords))
        pl, pst = model.decode_step(pst, torch.from_numpy(toks[:, S + t]),
                                    twords)
        _close(pl, jl, LOGIT_TOL[dtype])

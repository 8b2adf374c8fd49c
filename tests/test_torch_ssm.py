"""The port's Mamba mixer (``repro_torch.models.ssm``) against the Mamba
half of the JAX package's ``repro.models.ssm``, on the reduced jamba config
(d 128, di 256, ds 8, dc 4, dt_rank 8, chunks of 128) with the JAX
parameters loaded into the port's module and the same seeded inputs; then
the port's reduced Jamba model, prefill against prefill-then-decode.

Tolerances.  ``causal_conv`` is bit-equal in bfloat16 and float32 (the
same products and adds in the same order), and so is ``softplus`` in
bfloat16 wherever its result is a normal number (XLA's CPU backend flushes
subnormal results to zero, PyTorch keeps them; below -87 the two differ
by such a flush).  ``mamba_train`` and ``mamba_decode`` in float32: the
output within atol 1e-6, rtol 1e-5 (measured 3e-8 at outputs up to 0.5),
``h`` within atol 1e-8, rtol 1e-5 (measured 1.6e-9 at |h| up to 0.0066),
the conv state within 1e-5 (measured 1.7e-6: the input projection's
summation order): the chunk's doubling scan associates the recurrence in
another order than JAX's ``associative_scan``, and the products sum in
other orders, so the results agree to rounding, not to the bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
from repro.models import ssm as JS
from repro_torch import configs as C
from repro_torch.models import ssm as S
from repro_torch.models.transformer import Transformer

OUT = dict(atol=1e-6, rtol=1e-5)
H = dict(atol=1e-8, rtol=1e-5)
CONV = dict(atol=1e-5, rtol=1e-5)


def _configs(dtype="float32", **kw):
    jc = dataclasses.replace(JC.get_config("jamba_v01_52b", reduced=True),
                             compute_dtype=dtype, **kw)
    pc = dataclasses.replace(C.get_config("jamba_v01_52b", reduced=True),
                             compute_dtype=dtype, **kw)
    return jc, pc


@pytest.fixture(scope="module")
def mixer():
    jc, pc = _configs()
    jp = JS.mamba_params(jc, jax.random.key(2))
    m = S.Mamba(pc, torch.float32, "cpu", None)
    m.load_state_dict({k: torch.from_numpy(np.array(v))
                       for k, v in jp.items()})
    return jc, jp, pc, m


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **tol)


def _bits(t):
    return t.float().numpy().view(np.uint32)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_is_bit_equal(rng, dtype, with_state):
    x = rng.standard_normal((2, 50, 64)).astype(np.float32)
    w = (rng.standard_normal((4, 64)) * 0.3).astype(np.float32)
    b = rng.standard_normal(64).astype(np.float32)
    st = rng.standard_normal((2, 3, 64)).astype(np.float32) \
        if with_state else None
    tdt = getattr(torch, dtype)
    args = [None if a is None else torch.from_numpy(a).to(tdt)
            for a in (x, w, b, st)]
    y, new = S.causal_conv(*args)
    jy, jnew = JS._causal_conv(*[None if a is None else jnp.asarray(a, dtype)
                                 for a in (x, w, b, st)])
    assert y.dtype == tdt
    assert np.array_equal(_bits(y), np.asarray(jy, np.float32).view(
        np.uint32))
    assert np.array_equal(_bits(new), np.asarray(jnew, np.float32).view(
        np.uint32))


def test_softplus_is_jax_softplus_in_bf16(rng):
    x = (rng.standard_normal(200_000) * 12).clip(-80, 80).astype(np.float32)
    x[:8] = [0.0, -0.0, 20.0, 21.0, -20.0, 80.0, -80.0, 1e-8]
    got = S.softplus(torch.from_numpy(x).bfloat16())
    want = jax.nn.softplus(jnp.asarray(x, jnp.bfloat16))
    assert np.array_equal(_bits(got), np.asarray(want, np.float32).view(
        np.uint32))
    # past -87 the result is subnormal: XLA flushes it to zero
    deep = torch.tensor([-88.0, -89.0]).bfloat16()
    assert bool((S.softplus(deep) > 0).all())
    assert not np.asarray(jax.nn.softplus(jnp.asarray(
        [-88.0, -89.0], jnp.bfloat16)), np.float32).any()
    # float32: within an ulp or two (exp and log1p's own roundings)
    _close(S.softplus(torch.from_numpy(x)), jax.nn.softplus(jnp.asarray(x)),
           dict(atol=1e-6, rtol=1e-6))


@pytest.mark.parametrize("s", [128, 256, 1024])
def test_mamba_train_and_decode_match_jax(rng, mixer, s):
    """``mamba_train`` over 1, 2 and 8 chunks: the output and both parts
    of the final state; then 8 ``mamba_decode`` steps from that state."""
    jc, jp, pc, m = mixer
    x = rng.standard_normal((2, s, jc.d_model)).astype(np.float32)
    jo, jst = JS.mamba_train(jnp.asarray(x), jp, jc, return_state=True)
    o, (conv, h) = S.mamba_train(torch.from_numpy(x), m, pc,
                                 return_state=True)
    _close(o, jo, OUT)
    _close(h, jst["h"], H)
    _close(conv, jst["conv"], CONV)
    assert conv.shape == (2, pc.ssm_d_conv - 1, 2 * pc.d_model)
    assert h.dtype == torch.float32 and h.shape == (2, 256, pc.ssm_d_state)
    for _ in range(8):
        xt = rng.standard_normal((2, jc.d_model)).astype(np.float32)
        jo, jst = JS.mamba_decode(jnp.asarray(xt), jp, jc, jst)
        o, (conv, h) = S.mamba_decode(torch.from_numpy(xt), m, pc, conv, h)
        _close(o, jo, OUT)
        _close(h, jst["h"], H)
        _close(conv, jst["conv"], CONV)


@pytest.mark.parametrize("chunk", [1, 16, 128])
def test_chunked_scan_matches_the_per_token_recurrence(rng, mixer, chunk):
    """``selective_scan`` in chunks against ``selective_scan_steps`` (the
    plain per-token recurrence) on one layer's real inputs, float32
    outputs and final h within ``OUT`` and ``H``."""
    _, _, pc, m = mixer
    x = torch.from_numpy(rng.standard_normal((2, 256, pc.d_model)).astype(
        np.float32))
    _, _, xi, dt, bmat, cmat = S.scan_inputs(x, m, pc)
    y, h = S.selective_scan(xi, dt, bmat, cmat, m.A_log, chunk,
                            torch.float32)
    want_y, want_h = S.selective_scan_steps(xi, dt, bmat, cmat, m.A_log)
    np.testing.assert_allclose(y.numpy(), want_y.numpy(), **OUT)
    np.testing.assert_allclose(h.numpy(), want_h.numpy(), **H)


def test_mamba_without_state_matches_jax(rng, mixer):
    jc, jp, pc, m = mixer
    x = rng.standard_normal((1, 96, jc.d_model)).astype(np.float32)
    _close(S.mamba_train(torch.from_numpy(x), m, pc),
           JS.mamba_train(jnp.asarray(x), jp, jc), OUT)


def test_sequence_must_fill_whole_chunks(mixer):
    """JAX asserts S % chunk == 0 past one chunk; the port raises."""
    _, _, pc, m = mixer
    with pytest.raises(ValueError, match="ssm_chunk"):
        S.mamba_train(torch.zeros((1, 192, pc.d_model)), m, pc)


def test_decode_leaves_its_state_alone(rng, mixer):
    _, _, pc, m = mixer
    x = torch.from_numpy(rng.standard_normal((2, 128, pc.d_model)).astype(
        np.float32))
    _, (conv, h) = S.mamba_train(x, m, pc, return_state=True)
    conv0, h0 = conv.clone(), h.clone()
    xt = x[:, 0]
    a = S.mamba_decode(xt, m, pc, conv, h)
    b = S.mamba_decode(xt, m, pc, conv, h)
    assert torch.equal(conv, conv0) and torch.equal(h, h0)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1][1], b[1][1])
    assert a[1][1].data_ptr() != h.data_ptr()


def test_random_init_follows_jax(mixer):
    """Constants as JAX initialises them; the random weights' scales."""
    _, jp, pc, _ = mixer
    m = S.Mamba(pc, torch.bfloat16, "cpu", torch.Generator().manual_seed(0))
    sd = m.state_dict()
    assert set(sd) == set(jp)
    assert sd["A_log"].dtype == torch.float32
    _close(sd["A_log"], jp["A_log"], dict(atol=0, rtol=1e-7))
    for name in ("conv_b", "dt_bias", "D"):
        assert sd[name].dtype == torch.bfloat16
        _close(sd[name], jnp.asarray(jp[name], jnp.bfloat16),
               dict(atol=0, rtol=0))
    assert abs(float(sd["in_proj"].float().std()) - 128 ** -0.5) < 0.01


# ---------------------------------------------------- the whole model
def test_prefill_against_prefill_then_decode():
    """Reduced Jamba in float32: a prefill of 256 tokens against a prefill
    of 128 followed by 128 teacher-forced decode steps (every block
    visible): the same last logits within 1e-4 (measured 2.6e-6 at logits
    up to 3.4: flash attention against the decode attention, the chunked
    scan against the per-token recurrence), each mamba layer's state
    within ``H`` and ``CONV`` (measured 7.5e-9 and 3.5e-6) and the global
    layer's K cache within 1e-5 (measured 3.2e-6).  Capacity factor 1000,
    as in the JAX package's own check
    (``tests/models/test_consistency.py``): prefill and decode route the
    same tokens, but at decode's capacity of one token an expert
    collisions would drop choices that a 256-token prefill keeps."""
    _, pc = _configs(capacity_factor=1000.0)
    model = Transformer(pc, device="cpu",
                        generator=torch.Generator().manual_seed(4))
    toks = torch.from_numpy(np.random.default_rng(9).integers(
        0, pc.vocab, (2, 256)).astype(np.int32))
    want, full = model.prefill(toks, s_max=256)
    logits, st = model.prefill(toks[:, :128], s_max=256)
    words = torch.full((2, 1), -1, dtype=torch.int32)
    for t in range(128, 256):
        logits, st = model.decode_step(st, toks[:, t], words)
    np.testing.assert_allclose(logits.numpy(), want.numpy(), atol=1e-4,
                               rtol=1e-4)
    n_mamba = 0
    for i, (mix, _) in enumerate(pc.layer_kinds):
        if mix == "mamba":
            n_mamba += 1
            np.testing.assert_allclose(st.layers[i]["h"].numpy(),
                                       full.layers[i]["h"].numpy(), **H)
            np.testing.assert_allclose(st.layers[i]["conv"].numpy(),
                                       full.layers[i]["conv"].numpy(), **CONV)
            assert set(st.layers[i]) == {"conv", "h"}
        else:
            np.testing.assert_allclose(st.layers[i]["k"].numpy(),
                                       full.layers[i]["k"].numpy(),
                                       atol=1e-5, rtol=1e-5)
            assert set(st.layers[i]) == {"k", "v"}
    assert n_mamba == 7
    assert st.pos.tolist() == [256, 256]


@pytest.mark.parametrize("arch", ["jamba_v01_52b", "mixtral_8x7b"])
def test_engine_generates_as_jax(arch):
    """``Engine.generate`` on the hybrid and MoE models, unchanged in its
    interface: the JAX engine's greedy tokens in float32 compute (JAX's
    weights carried across), 32-token blocks so that ``BlockPolicy(1, 2)``
    hides six of the prompt's eight blocks from the global layers, the
    same mask words, and every page back after ``release_all``."""
    from repro.kernels import ops as jops
    from repro.models import transformer as JT
    from repro.serve import engine as jeng
    from repro_torch.convert import params_from_jax
    from repro_torch.serve import BlockPolicy, Engine
    jc = dataclasses.replace(JC.get_config(arch, reduced=True),
                             compute_dtype="float32", attn_block_size=32)
    pc = dataclasses.replace(C.get_config(arch, reduced=True),
                             compute_dtype="float32", attn_block_size=32)
    params = JT.init_params(jc, jax.random.key(0))
    model = Transformer(pc, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    prompts = np.random.default_rng(11).integers(
        0, jc.vocab, (2, 256)).astype(np.int32)
    old = jops._DEFAULT
    jops.set_default_backend("pallas")
    try:
        jengine = jeng.Engine(jc, params, max_seq=512,
                              policy=jeng.BlockPolicy(1, 2))
        want = jengine.generate(prompts, 6)
    finally:
        jops.set_default_backend(old)
    eng = Engine(model, max_seq=512, policy=BlockPolicy(1, 2))
    got = eng.generate(prompts, 6)
    assert got.dtype == np.int32 and np.array_equal(got, want)
    for key, words in eng._mask_cache.items():
        assert np.array_equal(words.numpy().view(np.uint32),
                              np.asarray(jengine._mask_cache[key]))
    eng.release_all()
    assert eng.allocator.n_free == eng.allocator.n_pages

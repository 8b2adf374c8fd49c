"""The port's serving layer (``repro_torch.serve``: the paged KV
allocator, constrained decoding, the block policy and the engine) against
the JAX package's ``repro.serve``: every case of
``tests/serve/test_serve.py`` but the routing telemetry (held in
``tests/test_torch_moe.py``), run on both packages with the same inputs,
allocator pages and free sets, constraint sets and mask words compared
exactly.  ``Engine.generate``
gives the JAX engine's tokens in float32 compute (in bfloat16, logits over
the vocabulary tie and round differently: see ``test_torch_model.py``),
with and without a constraint and a pinned block, on the reduced gemma2
config with the JAX weights (``convert.params_from_jax``) and a block size
of 32, so that the Roaring mask hides blocks of the prompt.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.configs as JC
from repro.core import RoaringBitmap as JBitmap
from repro.core.tensor import block_mask_words as jblock_mask_words
from repro.kernels import ops as jops
from repro.models import transformer as JT
from repro.serve import constrained as jcon
from repro.serve import engine as jeng
from repro.serve.kv_cache import PagedKVAllocator as JAllocator
from repro_torch import configs as C
from repro_torch.convert import params_from_jax
from repro_torch.core import RoaringBitmap
from repro_torch.core.tensor import block_mask_words
from repro_torch.models.transformer import Transformer
from repro_torch.serve import (BlockPolicy, Engine, PagedKVAllocator,
                               VocabConstraint, lexicon_constraint)

CPU = "cpu"


def _same_set(port_bm, jax_bm):
    assert np.array_equal(port_bm.to_array(), np.asarray(jax_bm.to_array()))


def _same_allocator(a, ja):
    assert a.tables == ja.tables
    assert a.n_free == ja.n_free
    _same_set(a.free, ja.free)
    _same_set(a.used_set(), ja.used_set())
    assert a.fragmentation() == ja.fragmentation()


# ---------------------------------------------------------------- kv cache
def test_alloc_release_cycle():
    a, ja = PagedKVAllocator(n_pages=64, device=CPU), JAllocator(n_pages=64)
    for alloc in (a, ja):
        p1 = alloc.allocate(1, 10)
        p2 = alloc.allocate(2, 20)
        assert len(set(p1) & set(p2)) == 0
        assert alloc.n_free == 34
    _same_allocator(a, ja)
    for alloc in (a, ja):
        alloc.release(1)
        assert alloc.n_free == 44
        assert alloc.owner_overlap(1, 2) == 0
    _same_allocator(a, ja)
    for alloc in (a, ja):
        alloc.allocate(3, 44)
        assert alloc.n_free == 0
        with pytest.raises(MemoryError):
            alloc.allocate(4, 1)
    _same_allocator(a, ja)


def test_extend_by_tokens():
    a = PagedKVAllocator(n_pages=16, page_size=128, device=CPU)
    ja = JAllocator(n_pages=16, page_size=128)
    for tokens, pages in ((100, 1), (129, 2), (129, 2)):   # idempotent
        for alloc in (a, ja):
            alloc.extend(0, tokens)
            assert len(alloc.pages_of(0)) == pages
        _same_allocator(a, ja)


def test_fragmentation_metric():
    a, ja = PagedKVAllocator(n_pages=64, device=CPU), JAllocator(n_pages=64)
    assert a.fragmentation() == ja.fragmentation() == 0.0
    for alloc in (a, ja):
        alloc.allocate(1, 8)
        alloc.allocate(2, 8)
        alloc.release(1)       # a hole at the front: [0..7] + [16..]
        assert 0.0 <= alloc.fragmentation() < 1.0
    _same_allocator(a, ja)


def test_owner_overlap_and_used_set():
    a, ja = PagedKVAllocator(n_pages=32, device=CPU), JAllocator(n_pages=32)
    for alloc in (a, ja):
        alloc.allocate(1, 5)
        alloc.allocate(2, 3)
        alloc.tables[2].extend(alloc.tables[1][:2])      # shared prefix
    assert a.owner_overlap(1, 2) == ja.owner_overlap(1, 2) == 2
    _same_allocator(a, ja)


# ------------------------------------------------------------- constrained
def test_constraint_algebra():
    v = 1000
    a = VocabConstraint(v, RoaringBitmap.from_range(0, 500), device=CPU)
    b = VocabConstraint(v, RoaringBitmap.from_range(250, 750), device=CPU)
    ja = jcon.VocabConstraint(v, JBitmap.from_range(0, 500))
    jb = jcon.VocabConstraint(v, JBitmap.from_range(250, 750))
    assert a.intersect(b).n_allowed() == 250
    assert a.union(b).n_allowed() == 750
    banned = a.ban(range(0, 500, 2))
    assert banned.n_allowed() == 250
    assert banned.feasible()
    assert not a.intersect(VocabConstraint(
        v, RoaringBitmap.from_range(600, 700), device=CPU)).feasible()
    _same_set(a.intersect(b).allowed, ja.intersect(jb).allowed)
    _same_set(a.union(b).allowed, ja.union(jb).allowed)
    _same_set(banned.allowed, ja.ban(range(0, 500, 2)).allowed)
    assert np.array_equal(banned.dense_mask(),
                          ja.ban(range(0, 500, 2)).dense_mask())


def test_constraint_apply_masks_logits(rng):
    v = 64
    c = VocabConstraint(v, RoaringBitmap.from_values([3, 7, 11]), device=CPU)
    jc = jcon.VocabConstraint(v, JBitmap.from_values([3, 7, 11]))
    logits = rng.standard_normal((2, v)).astype(np.float32)
    out = c.apply(torch.from_numpy(logits)).numpy()
    assert np.array_equal(out, np.asarray(jc.apply(logits)))
    allowed = {3, 7, 11}
    for t in range(v):
        if t in allowed:
            assert np.isfinite(out[:, t]).all()
        else:
            assert (out[:, t] == -np.inf).all()
    # bfloat16 logits promote to float32, as in the JAX package
    assert c.apply(torch.from_numpy(logits).bfloat16()).dtype == \
        torch.float32


def test_lexicon_union():
    lex = {"digits": np.arange(10), "alpha": np.arange(20, 40)}
    c = lexicon_constraint(100, lex, ["digits", "alpha"], device=CPU)
    assert c.n_allowed() == 30
    _same_set(c.allowed,
              jcon.lexicon_constraint(100, lex, ["digits", "alpha"]).allowed)
    assert lexicon_constraint(100, lex, [], device=CPU).n_allowed() == 100


# ---------------------------------------------------------- block policy
def test_block_policy_sets():
    pol = BlockPolicy(sink_blocks=2, local_blocks=3,
                      pinned=RoaringBitmap.from_values([10]))
    vis = pol.visible_set(kv_len=128 * 20, block_size=128, device=CPU)
    assert set(vis.to_array().tolist()) == {0, 1, 10, 17, 18, 19}
    jpol = jeng.BlockPolicy(sink_blocks=2, local_blocks=3,
                            pinned=JBitmap.from_values([10]))
    for kv_len in (1, 127, 128, 129, 128 * 20, 5000):
        _same_set(pol.visible_set(kv_len, 128, device=CPU),
                  jpol.visible_set(kv_len, 128))


def test_mask_words_cache():
    """_mask_words is cached on per-request block counts: decode steps
    inside one attention block reuse the rendered words."""
    cfg = dataclasses.make_dataclass("Cfg", ["attn_block_size"])(128)
    eng = Engine.__new__(Engine)            # skip the model
    eng.cfg = cfg
    eng.device = torch.device(CPU)
    eng.policy = BlockPolicy(sink_blocks=1, local_blocks=2)
    eng.n_blocks = 16
    eng._mask_cache = {}
    m1 = eng._mask_words([100, 200])
    m2 = eng._mask_words([120, 250])        # same block counts -> cache hit
    assert m2 is m1
    assert len(eng._mask_cache) == 1
    m3 = eng._mask_words([200, 250])        # first request crossed a block
    assert m3 is not m1
    assert len(eng._mask_cache) == 2
    # cached words match a fresh render, and the JAX package's words
    sets = [eng.policy.visible_set(kl, 128, device=CPU) for kl in (100, 200)]
    assert torch.equal(m1, block_mask_words(sets, 16, device=CPU))
    jpol = jeng.BlockPolicy(sink_blocks=1, local_blocks=2)
    jwords = np.asarray(jblock_mask_words(
        [jpol.visible_set(kl, 128) for kl in (100, 200)], 16))
    assert np.array_equal(m1.numpy().view(np.uint32), jwords)


# ------------------------------------------------------------------ engine
@pytest.fixture(scope="module")
def models():
    """The reduced gemma2 config in float32 compute with 32-token blocks,
    the JAX parameters and the port's model with the same weights."""
    jc = dataclasses.replace(JC.get_config("gemma2_27b", reduced=True),
                             compute_dtype="float32", attn_block_size=32)
    pc = dataclasses.replace(C.get_config("gemma2_27b", reduced=True),
                             compute_dtype="float32", attn_block_size=32)
    params = JT.init_params(jc, jax.random.key(0))
    model = Transformer(pc, device=CPU)
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return jc, params, pc, model


@pytest.mark.parametrize("pinned,allowed", [
    (None, None), ([2], None), ([2, 40], np.arange(100, 164))])
def test_generate_matches_jax(models, pinned, allowed):
    jc, params, pc, model = models
    prompts = np.random.default_rng(11).integers(
        0, jc.vocab, (2, 192)).astype(np.int32)
    pol = BlockPolicy(1, 2, None if pinned is None
                      else RoaringBitmap.from_values(pinned))
    jpol = jeng.BlockPolicy(1, 2, None if pinned is None
                            else JBitmap.from_values(pinned))
    con = jcon_ = None
    if allowed is not None:
        con = VocabConstraint(pc.vocab, RoaringBitmap.from_values(allowed),
                              device=CPU)
        jcon_ = jcon.VocabConstraint(jc.vocab, JBitmap.from_values(allowed))
    eng = Engine(model, max_seq=512, policy=pol, constraint=con)
    old = jops._DEFAULT
    jops.set_default_backend("pallas")
    try:
        jeng_ = jeng.Engine(jc, params, max_seq=512, policy=jpol,
                            constraint=jcon_)
        want = jeng_.generate(prompts, 8)
    finally:
        jops.set_default_backend(old)
    got = eng.generate(prompts, 8)
    assert got.dtype == np.int32 and got.shape == (2, 8)
    assert np.array_equal(got, want)
    if allowed is not None:
        assert np.isin(got, allowed).all()
    _same_allocator(eng.allocator, jeng_.allocator)
    for key, words in eng._mask_cache.items():
        assert np.array_equal(words.numpy().view(np.uint32),
                              np.asarray(jeng_._mask_cache[key]))
    eng.release_all()
    assert eng.allocator.n_free == eng.allocator.n_pages


def test_engine_generates_and_respects_constraint(rng, models):
    """The JAX package's engine test on the port: greedy, then sampled
    from the engine's generator (reproducible from its seed)."""
    _, _, pc, model = models
    allowed = RoaringBitmap.from_values(np.arange(32, dtype=np.uint32))
    prompts = rng.integers(0, pc.vocab, (2, 64)).astype(np.int32)
    outs = []
    for greedy, seed in ((True, 0), (False, 3), (False, 3)):
        eng = Engine(model, max_seq=128,
                     policy=BlockPolicy(sink_blocks=1, local_blocks=4),
                     constraint=VocabConstraint(pc.vocab, allowed,
                                                device=CPU),
                     greedy=greedy, seed=seed)
        out = eng.generate(prompts, max_new_tokens=6)
        assert out.shape == (2, 6)
        assert (out < 32).all(), "constrained decoding must honor the set"
        eng.release_all()
        assert eng.allocator.n_free == eng.allocator.n_pages
        outs.append(out)
    assert np.array_equal(outs[1], outs[2])
    with pytest.raises(ValueError, match="max_seq"):
        Engine(model, max_seq=128).generate(prompts, 65)


def test_defaults_need_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a GPU")
    with pytest.raises(RuntimeError, match="CUDA"):
        PagedKVAllocator(n_pages=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        VocabConstraint(8)
    with pytest.raises(RuntimeError, match="CUDA"):
        BlockPolicy().visible_set(4096, 128)

"""The port's plain Roaring block-sparse decode attention
(``repro_torch.kernels.ref.block_sparse_attention_decode``, which the CPU
route of ``ops.decode_attention`` runs) against the JAX package's Pallas
kernel in interpret mode and its jnp ``ref``, on the same seeded inputs.

Tolerances: float32 2e-5 against both (the JAX kernel test's).  bfloat16
1e-2 against Pallas: both compute the same function in float32 from the
same bf16 inputs and round once to bf16, so they differ by summation order
and at most one bf16 ulp of an output below 2 (0.0078).  bfloat16 3e-2
against ``ref`` (the JAX test's): ``ref`` rounds the softmax weights to
bf16 before the PV product, a different function (ROADMAP Queue 3), which
``test_bf16_split_follows_the_kernel`` pins.

The kernel's two steps, plainly (``ref.decode_attention_partials`` then
``ref.combine_partials``), against the Pallas kernel at the same
tolerances, for P in {1, 2, 3, the block count}.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.block_sparse_attn import decode_attention as pallas_decode
from repro_torch.kernels import block_sparse_attn as bsa
from repro_torch.kernels import ops
from repro_torch.kernels import ref

SWEEP = [(2, 8, 2, 64, 1024, 128), (1, 4, 4, 128, 512, 128),
         (3, 16, 8, 64, 1024, 256)]


def make_case(rng, b, h, hkv, d, s, bs, density):
    """The JAX kernel test's generator: visible blocks drawn per row,
    kv_len in [1, S]."""
    nblk = s // bs
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    k = (rng.standard_normal((b, hkv, s, d)) * 0.3).astype(np.float32)
    v = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    words = max(1, (nblk + 31) // 32)
    mask = np.zeros((b, words), np.uint32)
    for i in range(b):
        sel = rng.choice(nblk, int(round(density * nblk)), replace=False)
        for s_ in sel:
            mask[i, s_ >> 5] |= np.uint32(1) << np.uint32(s_ & 31)
    kvl = rng.integers(1, s + 1, b).astype(np.int32)
    return q, k, v, mask, kvl


def _jax(case, dtype):
    q, k, v, mask, kvl = case
    return [jnp.asarray(q, dtype), jnp.asarray(k, dtype),
            jnp.asarray(v, dtype), jnp.asarray(mask), jnp.asarray(kvl)]


def _torch(case, dtype):
    q, k, v, mask, kvl = case
    return [torch.from_numpy(q).to(dtype), torch.from_numpy(k).to(dtype),
            torch.from_numpy(v).to(dtype),
            torch.from_numpy(mask.view(np.int32)), torch.from_numpy(kvl)]


def _np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor) else x,
                      np.float32)


def _port(case, dtype, **kw):
    return ref.block_sparse_attention_decode(*_torch(case, dtype), **kw)


@pytest.mark.parametrize("b,h,hkv,d,s,bs", SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_and_ref(rng, b, h, hkv, d, s, bs, dtype):
    case = make_case(rng, b, h, hkv, d, s, bs, 0.5)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    got = _port(case, tdt, block_size=bs)
    assert got.dtype == tdt and got.shape == (b, h, d)
    pallas = pallas_decode(*_jax(case, jdt), block_size=bs, interpret=True)
    want_ref = jref.block_sparse_attention_decode(*_jax(case, jdt),
                                                  block_size=bs)
    f32 = dtype == "float32"
    np.testing.assert_allclose(_np(got), _np(pallas), atol=2e-5 if f32
                               else 1e-2, rtol=2e-5 if f32 else 1e-2)
    np.testing.assert_allclose(_np(got), _np(want_ref), atol=2e-5 if f32
                               else 3e-2, rtol=2e-5 if f32 else 3e-2)


def test_bf16_split_follows_the_kernel(rng):
    """In bfloat16 the JAX package's two versions compute different
    functions: ``ref`` rounds the weights to bf16 before the PV product,
    the Pallas kernel keeps them in float32.  The port's plain version is
    the kernel's: its distance to Pallas is well below ref's."""
    case = make_case(rng, 4, 8, 2, 64, 2048, 128, 0.75)
    jb = _jax(case, jnp.bfloat16)
    pallas = _np(pallas_decode(*jb, block_size=128, interpret=True))
    jax_ref = _np(jref.block_sparse_attention_decode(*jb, block_size=128))
    port = _np(_port(case, torch.bfloat16, block_size=128))
    split = np.abs(pallas - jax_ref).max()
    assert split > 0
    assert np.abs(port - pallas).max() < split / 2
    assert np.abs(port - jax_ref).max() > np.abs(port - pallas).max()


def test_empty_mask_returns_zeros(rng):
    case = make_case(rng, 2, 4, 2, 64, 512, 128, 0.5)
    case[3][:] = 0
    got = _port(case, torch.float32, block_size=128)
    assert torch.equal(got, torch.zeros_like(got))
    pallas = _np(pallas_decode(*_jax(case, jnp.float32), block_size=128,
                               interpret=True))
    assert np.array_equal(pallas, np.zeros_like(pallas))


def test_full_mask_equals_dense(rng):
    case = make_case(rng, 2, 8, 4, 64, 512, 128, 1.0)
    q, k, v, mask, kvl = case
    mask[:] = 0xFFFFFFFF
    got = _np(_port(case, torch.float32, block_size=128))
    scale = 64 ** -0.5
    for i in range(2):
        n = int(kvl[i])
        qg = q[i].reshape(4, 2, 64)
        sc = np.einsum("kgd,ksd->kgs", qg, k[i][:, :n]) * scale
        w = np.exp(sc - sc.max(-1, keepdims=True))
        w /= w.sum(-1, keepdims=True)
        want = np.einsum("kgs,ksd->kgd", w, v[i][:, :n]).reshape(8, 64)
        np.testing.assert_allclose(got[i], want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("softcap", [5.0, 50.0])
def test_softcap(rng, softcap):
    case = make_case(rng, 1, 4, 4, 32, 256, 128, 1.0)
    case[3][:] = 0xFFFFFFFF
    case[0][:] *= softcap / 2             # scores of the softcap's order
    got = _np(_port(case, torch.float32, block_size=128, softcap=softcap))
    want = _np(pallas_decode(*_jax(case, jnp.float32), block_size=128,
                             softcap=softcap, interpret=True))
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
    plain = _np(_port(case, torch.float32, block_size=128))
    assert np.abs(plain - got).max() > 1e-5


@pytest.mark.parametrize("kvl", [[0, 1], [63, 64], [65, 200], [256, 256]])
def test_kv_len_edges(rng, kvl):
    """kv_len 0 (nothing visible: zeros), 1, mid-block, a block edge and
    S, with bits set past kv_len and a row whose only bits lie past it."""
    case = make_case(rng, 2, 8, 2, 32, 256, 64, 1.0)
    case[4][:] = kvl
    case[3][1] = 0b1100                   # blocks 2 and 3 only
    for dtype in ("float32", "bfloat16"):
        got = _port(case, getattr(torch, dtype), block_size=64)
        want = pallas_decode(*_jax(case, getattr(jnp, dtype)), block_size=64,
                             interpret=True)
        tol = 2e-5 if dtype == "float32" else 1e-2
        np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)
        if kvl[0] == 0:
            assert not _np(got)[0].any()
        if kvl[1] <= 128:
            assert not _np(got)[1].any()


@pytest.mark.parametrize("g", [1, 2, 8])
def test_query_groups(rng, g):
    case = make_case(rng, 2, 2 * g, 2, 32, 512, 128, 0.5)
    got = _port(case, torch.float32, block_size=128, sm_scale=0.3)
    want = pallas_decode(*_jax(case, jnp.float32), block_size=128,
                         sm_scale=0.3, interpret=True)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5, rtol=2e-5)


def test_ops_routes_by_device_and_backend(rng):
    case = make_case(rng, 2, 4, 2, 32, 256, 128, 0.5)
    args = _torch(case, torch.float32)
    want = ref.block_sparse_attention_decode(*args, block_size=128)
    n0 = bsa.launches
    for backend in (None, "ref"):
        got = ops.decode_attention(*args, block_size=128, backend=backend)
        assert torch.equal(got, want)
    assert torch.equal(bsa.decode_attention(*args, block_size=128), want)
    assert bsa.launches == n0            # the CPU route launches nothing
    with pytest.raises(ValueError, match="cuda"):
        ops.decode_attention(*args, block_size=128, backend="cuda")


def test_kernel_route_does_not_fall_back_to_cpu():
    """On a tensor that is neither on the CPU nor a GPU the wrapper never
    computes the plain version: on meta tensors (the dry run's) it gives
    the output's shape on meta and launches nothing, and the entry point
    without a meta shape rule raises."""
    meta = dict(device="meta")
    q = torch.zeros((2, 4, 32), **meta)
    k = torch.zeros((2, 2, 256, 32), **meta)
    words = torch.zeros((2, 1), dtype=torch.int32, **meta)
    kvl = torch.zeros(2, dtype=torch.int32, **meta)
    n0 = bsa.launches
    out = bsa.decode_attention(q, k, k, words, kvl)
    assert out.device.type == "meta" and out.shape == q.shape
    assert out.dtype == q.dtype and bsa.launches == n0
    with pytest.raises(ValueError, match="CUDA"):
        bsa.decode_attention_with_partials(q, k, k, words, kvl)


def _split_case(rng, dtype):
    """Three rows over 8 blocks of 64: kv_len mid-block under a random
    mask, nothing visible (mask 0), and one visible block cut at kv_len =
    80 (two chunks of 8 keys, so P = 3 and 8 have empty ranges) with a bit
    set past kv_len."""
    case = make_case(rng, 3, 8, 2, 32, 512, 64, 0.5)
    case[3][1] = 0
    case[3][2] = 0b1000_0010
    case[4][:] = [300, 512, 80]
    return case


@pytest.mark.parametrize("splits", [1, 2, 3, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_then_combine_matches_pallas(rng, splits, dtype):
    """The plain split step (``ref.decode_attention_partials``) then the
    plain merge (``ref.combine_partials``) against the Pallas kernel in
    interpret mode, for P in {1, 2, 3, the block count}: float32 within
    2e-5, bfloat16 within 1e-2 (the module's tolerances); empty ranges
    hold (m, l) = (-1e30, 0) and the row with nothing visible is 0."""
    case = _split_case(rng, dtype)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    args = _torch(case, tdt)
    part = ref.decode_attention_partials(*args, splits, block_size=64,
                                         softcap=20.0)
    assert part.shape == (3, 8, splits, 34) and part.dtype == torch.float32
    got = ref.combine_partials(part).to(tdt)
    want = pallas_decode(*_jax(case, jdt), block_size=64, softcap=20.0,
                         interpret=True)
    tol = 2e-5 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)
    assert not _np(got)[1].any()
    empty = part[..., 1] == 0
    assert bool((part[..., 0][empty] == ref.NEG_INF).all())
    assert bool(empty[1].all())
    if splits >= 3:
        assert bool(empty[2].any()) and not bool(empty[2].all())
    out, kept = bsa.decode_attention_with_partials(
        *args, block_size=64, softcap=20.0, splits=splits)
    assert torch.equal(out, got)
    assert (kept is None) == (splits == 1)


def test_split_ranges_cover_each_visible_key_once(rng):
    """Every visible key below kv_len lands in exactly one range: the P
    partials' weights, rescaled to the row's max, sum to the one-range
    sum whatever P."""
    case = _split_case(rng, "float32")
    args = _torch(case, torch.float32)
    sums = []
    for splits in (1, 2, 3, 5, 8, 13):
        part = ref.decode_attention_partials(*args, splits, block_size=64)
        m = part[..., 0]
        w = torch.exp(m - m.amax(dim=-1, keepdim=True))
        sums.append((part[..., 1] * w).sum(dim=-1))
    for s_ in sums[1:]:
        torch.testing.assert_close(s_, sums[0], atol=1e-6, rtol=1e-6)

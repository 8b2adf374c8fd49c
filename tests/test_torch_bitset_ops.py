"""The port's fused bitset op and count (``repro_torch.kernels.bitset_ops``
and their plain versions in ``kernels/ref.py``) against the JAX package's
Pallas kernels run in interpret mode, its jnp oracle and numpy, on the same
seeded inputs.

Inputs: every op ("and", "or", "xor", "andnot") at N in {1, 2, 9, 17} rows
of random words with an all-zero row, an all-ones row and a row equal on
both sides.  N = 0 is held against the JAX ``ref`` only: there the Pallas
wrapper cannot slice its 8-row block out of an empty operand, while
``ref`` returns empty arrays, and the port follows ``ref`` (ROADMAP Queue 3).
Words are compared bit for bit through ``.view(np.uint32)``; tolerance 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import bitset_ops as jbitset
from repro.kernels import ref as jref
from repro_torch.kernels import bitset_ops as tbitset
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

WORDS = tref.WORDS
OPS = ("and", "or", "xor", "andnot")
NP_OPS = {"and": lambda a, b: a & b, "or": lambda a, b: a | b,
          "xor": lambda a, b: a ^ b, "andnot": lambda a, b: a & ~b}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _u32(t):
    return t.numpy().view(np.uint32)


def _pair(n, seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 1 << 32, (n, WORDS), dtype=np.uint32)
    b = rng.integers(0, 1 << 32, (n, WORDS), dtype=np.uint32)
    if n >= 9:
        a[1], b[1] = 0, 0xFFFFFFFF
        a[2] = b[2] = 0xFFFFFFFF
        b[3] = a[3]
        a[4] = b[4] = 0
    return a, b


@pytest.mark.parametrize("n", [1, 2, 9, 17])
@pytest.mark.parametrize("op", OPS)
def test_bitset_op_matches_jax_and_numpy(op, n):
    a, b = _pair(n, 100 * n + OPS.index(op))
    want_w = NP_OPS[op](a, b)
    want_c = np.bitwise_count(want_w).sum(axis=1).astype(np.int32)
    tw, tc = tbitset.bitset_op(_t(a), _t(b), op)
    assert tw.dtype == torch.int32 and tc.dtype == torch.int32
    assert np.array_equal(_u32(tw), want_w)
    assert np.array_equal(tc.numpy(), want_c)
    assert np.array_equal(tbitset.bitset_op_card(_t(a), _t(b), op).numpy(),
                          want_c)
    jw, jc = jref.bitset_op(jnp.asarray(a), jnp.asarray(b), op)
    assert np.array_equal(_u32(tw), np.asarray(jw))
    assert np.array_equal(tc.numpy(), np.asarray(jc))
    assert np.array_equal(tc.numpy(), np.asarray(
        jref.bitset_op_card(jnp.asarray(a), jnp.asarray(b), op)))
    pw, pc = jbitset.bitset_op(jnp.asarray(a), jnp.asarray(b), op,
                               interpret=True)
    assert np.array_equal(_u32(tw), np.asarray(pw))
    assert np.array_equal(tc.numpy(), np.asarray(pc))
    assert np.array_equal(tc.numpy(), np.asarray(jbitset.bitset_op_card(
        jnp.asarray(a), jnp.asarray(b), op, interpret=True)))


@pytest.mark.parametrize("op", OPS)
def test_zero_rows_follow_the_jax_ref(op):
    """N = 0: empty words and cards, as ``repro.kernels.ref.bitset_op``
    gives (the Pallas wrapper raises there)."""
    z = np.zeros((0, WORDS), np.uint32)
    jw, jc = jref.bitset_op(jnp.asarray(z), jnp.asarray(z), op)
    for backend in (None, "ref"):
        tw, tc = tops.bitset_op(_t(z), _t(z), op, backend=backend)
        assert tw.shape == tuple(jw.shape) and tw.dtype == torch.int32
        assert tc.shape == tuple(jc.shape) and tc.dtype == torch.int32
        assert tops.bitset_op_card(_t(z), _t(z), op,
                                   backend=backend).shape == (0,)


def test_plain_popcount_chunks_agree(monkeypatch):
    """The plain version's row chunks: a chunk of 3 rows gives the cards
    of one pass."""
    a, b = _pair(17, 7)
    want = tref.bitset_op(_t(a), _t(b), "xor")
    monkeypatch.setattr(tref, "_POP_CHUNK", 3)
    got = tref.bitset_op(_t(a), _t(b), "xor")
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("op", ["nand", "AND", "", None])
def test_unknown_op_raises_value_error_on_every_route(op):
    a, b = _pair(2, 3)
    meta = torch.zeros((2, WORDS), dtype=torch.int32, device="meta")
    calls = [lambda: tref.bitset_op(_t(a), _t(b), op),
             lambda: tref.bitset_op_card(_t(a), _t(b), op),
             lambda: tbitset.bitset_op(_t(a), _t(b), op),
             lambda: tbitset.bitset_op_card(_t(a), _t(b), op),
             # the launch path checks the op before the device
             lambda: tbitset.bitset_op(meta, meta, op),
             lambda: tbitset.bitset_op_card(meta, meta, op)]
    for backend in (None, "ref"):
        calls += [lambda b_=backend: tops.bitset_op(_t(a), _t(b), op,
                                                    backend=b_),
                  lambda b_=backend: tops.bitset_op_card(_t(a), _t(b), op,
                                                         backend=b_)]
    for call in calls:
        with pytest.raises(ValueError, match="unknown op"):
            call()


@pytest.mark.parametrize("backend", [None, "ref"])
def test_ops_switch_on_cpu(backend):
    a, b = _pair(9, 11)
    tbitset.reset_launches()
    for op in OPS:
        want = tref.bitset_op(_t(a), _t(b), op)
        got = tops.bitset_op(_t(a), _t(b), op, backend=backend)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert torch.equal(tops.bitset_op_card(_t(a), _t(b), op,
                                               backend=backend), want[1])
    assert tbitset.launches == 0
    assert tbitset.launches_by_kernel == {"bitset_op": 0,
                                          "bitset_op_card": 0}


def test_forced_cuda_backend_raises_on_cpu_tensors():
    z = torch.zeros((2, WORDS), dtype=torch.int32)
    with pytest.raises(ValueError, match="cuda"):
        tops.bitset_op(z, z, "and", backend="cuda")
    with pytest.raises(ValueError, match="cuda"):
        tops.bitset_op_card(z, z, "or", backend="cuda")


def test_wrappers_refuse_non_cuda_devices():
    """A tensor that is neither on the CPU nor on a GPU raises in the
    launch path instead of being computed by the plain version."""
    meta = torch.zeros((2, WORDS), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tbitset.bitset_op(meta, meta, "and")
    with pytest.raises(ValueError, match="CUDA"):
        tbitset.bitset_op_card(meta, meta, "andnot")

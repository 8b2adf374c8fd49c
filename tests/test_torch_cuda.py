"""The CUDA segment_reduce kernel against its plain PyTorch version, on the
card.  Every row source (slab, ids, dual) x op, with empty segments,
one-row segments, per-segment T, weights and T above every count.  Words
must be bit-identical and cards equal: this is integer work.

These tests need an NVIDIA GPU and ``nvcc``; elsewhere they skip.  Run
them on a GPU machine with ``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_cuda.py``.  The file imports neither JAX nor ``repro``.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref, segment_ops
from repro_torch.kernels.ref import WORDS

pytestmark = pytest.mark.cuda

SOURCES = ("slab", "ids", "dual")
CASES = [("or", None, False), ("and", None, False), ("xor", None, False),
         ("andnot", None, False), ("threshold", "scalar", False),
         ("threshold", "per_segment", False),
         ("threshold", "per_segment", True)]


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(seed, lens, n_table=64, n_staged=8):
    rng = np.random.default_rng(seed)
    table = rng.integers(0, 1 << 32, (n_table, WORDS), dtype=np.uint32)
    table[0] = 0                                  # reserved zero row
    table[5] = table[6] = table[7]                # exact count ties
    staged = rng.integers(0, 1 << 32, (n_staged, WORDS), dtype=np.uint32)
    staged[0] = 0
    n = int(sum(lens))
    ids = rng.integers(1, n_table, n).astype(np.int32)
    cold = rng.random(n) < 0.3
    pos = np.where(cold, 0, ids).astype(np.int32)
    sidx = np.where(cold, rng.integers(1, n_staged, n), 0).astype(np.int32)
    starts = np.concatenate(([0], np.cumsum(lens))).astype(np.int32)
    weights = rng.integers(1, 5, n).astype(np.int32)
    return table, staged, ids, pos, sidx, starts, weights


def _call(fn_src, dev, arrays, op, tmode, weighted, jmax):
    table, staged, ids, pos, sidx, starts, weights = arrays
    t = lambda a: torch.from_numpy(a.view(np.int32)).to(dev)  # noqa: E731
    s = starts.shape[0] - 1
    kw = dict(jmax=jmax)
    planes = None
    if op == "threshold":
        lens = np.diff(starts)
        if tmode == "scalar":
            kw["threshold"] = 2
        else:
            tv = np.maximum(1, (lens * (3 if weighted else 1)) // 2)
            tv[::3] = lens[::3] * (4 if weighted else 1) + 1   # unreachable
            kw["threshold"] = t(tv.astype(np.int32))
        tmax = int(np.max(np.asarray(kw["threshold"].cpu()
                                     if tmode != "scalar" else 2)))
        total = int(lens.max()) * (4 if weighted else 1)
        planes = max(1, total.bit_length(), tmax.bit_length())
        if weighted:
            kw["weights"] = t(weights)
    assert s >= 1
    if fn_src == "slab":
        slab = table[ids]
        args = (t(slab), t(starts))
        plain, kern = ref.segment_reduce, segment_ops.segment_reduce
    elif fn_src == "ids":
        args = (t(table), t(ids), t(starts))
        plain, kern = ref.segment_reduce_rows, segment_ops.segment_reduce_rows
    else:
        args = (t(table), t(staged), t(pos), t(sidx), t(starts))
        plain = ref.segment_reduce_rows_dual
        kern = segment_ops.segment_reduce_rows_dual
    want_w, want_c = plain(*args, op, **kw)
    n0 = segment_ops.launches
    got_w, got_c = kern(*args, op, planes=planes,
                        wbits=3 if weighted else 1, **kw)
    torch.cuda.synchronize()
    assert segment_ops.launches == n0 + 1
    return want_w, want_c, got_w, got_c


@pytest.mark.parametrize("src", SOURCES)
@pytest.mark.parametrize("op,tmode,weighted", CASES)
@pytest.mark.parametrize("lens", [[3, 0, 5, 1, 0, 7, 2, 9, 4],
                                  [1, 1, 1, 1], [0, 0]])
def test_kernel_matches_plain(cuda, src, op, tmode, weighted, lens):
    jmax = max(1, max(lens))
    got = _call(src, cuda, _inputs(len(lens), lens), op, tmode, weighted,
                jmax)
    want_w, want_c, got_w, got_c = got
    assert torch.equal(got_w, want_w)
    assert torch.equal(got_c, want_c)
    empty = torch.tensor([x == 0 for x in lens], device=cuda)
    assert not got_w[empty].any() and not got_c[empty].any()


def test_kernel_raises_on_bad_input(cuda):
    slab = torch.zeros((4, WORDS), dtype=torch.int32, device=cuda)
    starts = torch.tensor([0, 4], dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        segment_ops.segment_reduce(slab.to(torch.int64), starts, "or",
                                   jmax=4)
    with pytest.raises(ValueError):
        segment_ops.segment_reduce(slab, starts.cpu(), "or", jmax=4)
    with pytest.raises(ValueError):
        segment_ops.segment_reduce(slab[:, ::2], starts, "or", jmax=4)


@pytest.mark.parametrize("bad", ["ids", "sidx", "starts"])
def test_out_of_range_index_faults(cuda, bad):
    """An out-of-range row index or segment offset traps in the kernel and
    raises at the next synchronisation instead of reading past the table.
    It runs in a child process: a trap leaves the CUDA context unusable."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    code = f"""
import torch
from repro_torch.kernels import segment_ops as so
dev = torch.device("cuda")
table = torch.zeros((8, 2048), dtype=torch.int32, device=dev)
staged = torch.zeros((2, 2048), dtype=torch.int32, device=dev)
pos = torch.tensor([1, 2, 3], dtype=torch.int32, device=dev)
sidx = torch.tensor([0, 0, 1], dtype=torch.int32, device=dev)
starts = torch.tensor([0, 3], dtype=torch.int32, device=dev)
bad = {bad!r}
if bad == "ids":
    pos[1] = 8
elif bad == "sidx":
    sidx[2] = 2
else:
    starts[1] = 4
so.segment_reduce_rows_dual(table, staged, pos, sidx, starts, "or", jmax=3)
torch.cuda.synchronize()
print("NO FAULT")
"""
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, env=env)
    assert proc.returncode != 0, proc.stdout
    assert "NO FAULT" not in proc.stdout


@pytest.mark.parametrize("t", [1, 5, 14])
def test_default_planes_cover_weights_and_int_t(cuda, t):
    """Without ``planes`` the counter is wide enough for jmax rows of
    weight < 2^wbits and for an int T, so the kernel still equals the plain
    version (14 > 3 * 4 is above every count)."""
    x = _inputs(5, [3, 1, 0, 2])
    table, _, ids, _, _, starts, weights = x
    tt = lambda a: torch.from_numpy(a.view(np.int32)).to(cuda)  # noqa: E731
    args = (tt(table[ids]), tt(starts), "threshold")
    kw = dict(jmax=3, threshold=t, weights=tt(weights))
    want = ref.segment_reduce(*args, **kw)
    got = segment_ops.segment_reduce(*args, wbits=3, **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])

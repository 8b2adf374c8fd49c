"""The port's optimizer and gradient compression (``repro_torch.optim``)
against the JAX package's ``repro/optim``, on seeded numpy inputs.

AdamW.  The port computes JAX's operations in JAX's order, in float32, but
XLA on the CPU contracts ``b1 * m + (1 - b1) * g`` (and the other
multiply-adds) into one fused multiply-add, which rounds once where the
port rounds twice (checked below against a float64 model of both).  So
one step from a random state lands within 2 float32 ulps of each leaf's
largest magnitude (measured: 1), and the schedule ``lr_at``, whose cosine
and power are XLA's and PyTorch's own, within 4 ulps (measured: 3 at 3 of
60 steps, the rest equal).  The global norm sums each leaf's sum of
squares in sorted-key order, as ``jax.tree.leaves`` of the same dict; the
sums inside a leaf are ordered by each library, so the norm is held
within 1e-6 relative (measured 0 on this test's tree, 2.1e-7 on another),
and a clipped step, scaled by the norms' ratio, within the same 2 ulps
(measured: 1).

Compression.  ``topk_sparsify`` keeps the lowest index among equal
magnitudes, as ``jax.lax.top_k``: indices and values equal, also on
inputs made of ties.  ``sparse_allreduce`` over a ``WideMesh`` of R CPU
devices (R in 1, 3, 4) against JAX's own ``topk_sparsify`` and
``densify`` of the R replicas' pairs divided by R (what its
``shard_map`` body computes), and for R = 1 against the ``shard_map``
itself: residuals equal, the reduced gradient within 1 float32 ulp of
its largest magnitude (the scatter-add of repeated coordinates is ordered
by each library; measured: equal).  ``wire_bytes_sparse`` and the
coordinate bitmap equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as JA
from repro.optim import compress as JCMP
from repro_torch.dist import WideMesh
from repro_torch.optim import adamw as PA
from repro_torch.optim import compress as PCMP

SHAPES = {"embed": (64, 32), "final_norm": {"scale": (32,)},
          "layers": {"0": {"wq": (32, 4, 8), "bq": (4, 8)}}}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small shapes: the suite runs several
    workers on the same cores, and torch's default of a thread a core
    oversubscribes them (30 small train steps took 121 s so, 1 s alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(rng, shapes, scale=1.0):
    return {k: (_tree(rng, v, scale) if isinstance(v, dict) else
                (rng.standard_normal(v) * scale).astype(np.float32))
            for k, v in shapes.items()}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else k
        out.update(_flat(v, key) if isinstance(v, dict) else {key: v})
    return out


def _ulps_of_max(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got.astype(np.float64) - want).max()
                 / np.spacing(np.abs(want).max()))


def test_lr_schedule():
    cfg = dict(lr=1e-3, warmup_steps=5, total_steps=50, min_lr_ratio=0.1)
    jc, pc = JA.AdamWConfig(**cfg), PA.AdamWConfig(**cfg)
    for step in range(60):
        want = np.float32(JA.lr_at(jc, jnp.int32(step)))
        got = PA.lr_at(pc, step)
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        assert _ulps_of_max(got.numpy(), want) <= 4, step
    # warm-up exact: step / warmup in float32
    assert float(PA.lr_at(pc, 2)) == float(np.float32(1e-3) * np.float32(
        np.float32(2) / np.float32(5)) * np.float32(1.0))


def test_xla_fuses_the_multiply_add():
    """Why AdamW is held to 2 ulps: XLA's CPU program for b1 * m + (1 - b1)
    * g equals one fused multiply-add of b1 * m, not two roundings."""
    rng = np.random.default_rng(1)
    m, g = (rng.standard_normal(4096).astype(np.float32) for _ in range(2))
    got = np.asarray(jax.jit(lambda m, g: 0.9 * m + (1 - 0.9) * g)(m, g))
    t = np.float32(1 - 0.9) * g
    fused = (np.float64(np.float32(0.9)) * m + t).astype(np.float32)
    assert np.array_equal(got, fused)
    port = PA.AdamWConfig()
    two = (torch.from_numpy(m) * 0.9).add_(torch.from_numpy(g) * (1 - 0.9))
    assert port.b1 == 0.9
    assert np.abs(two.numpy() - got).max() <= np.spacing(np.abs(got).max())


@pytest.mark.parametrize("clip", [1e9, 1.0])
def test_one_adamw_step_from_a_random_state(clip):
    rng = np.random.default_rng(7)
    p, g = _tree(rng, SHAPES), _tree(rng, SHAPES, 0.3)
    m = _tree(rng, SHAPES, 0.05)
    v = {k: np.abs(x) for k, x in _flat(_tree(rng, SHAPES, 0.01)).items()}
    cfg = dict(lr=1e-3, warmup_steps=5, total_steps=50, grad_clip=clip)
    jc, pc = JA.AdamWConfig(**cfg), PA.AdamWConfig(**cfg)
    jst = {"m": jax.tree.map(jnp.asarray, m),
           "v": jax.tree.map(jnp.asarray, _unflat(v)),
           "step": jnp.int32(3)}
    jp, jst2, jm = jax.jit(lambda p, g, s: JA.apply_updates(p, g, s, jc))(
        jax.tree.map(jnp.asarray, p), jax.tree.map(jnp.asarray, g), jst)
    tp = {k: torch.from_numpy(x.copy()) for k, x in _flat(p).items()}
    tg = {k: torch.from_numpy(x) for k, x in _flat(g).items()}
    pst = {"m": {k: torch.from_numpy(x.copy()) for k, x in _flat(m).items()},
           "v": {k: torch.from_numpy(x.copy()) for k, x in v.items()},
           "step": torch.tensor(3, dtype=torch.int32)}
    tp2, pst2, pm = PA.apply_updates(tp, tg, pst, pc)
    assert tp2 is tp and pst2["m"] is pst["m"]         # in place
    assert int(pst2["step"]) == int(jst2["step"]) == 4
    assert float(pm["lr"]) == float(jm["lr"])
    gn_j, gn_p = float(jm["grad_norm"]), float(pm["grad_norm"])
    assert abs(gn_p - gn_j) <= 1e-6 * gn_j
    if clip < gn_j:
        assert gn_j > 2 * clip        # the clip is active in this case
    for name, want, got in (("p", jp, tp2), ("m", jst2["m"], pst2["m"]),
                            ("v", jst2["v"], pst2["v"])):
        want = _flat(jax.tree.map(np.asarray, want))
        for k in want:
            assert _ulps_of_max(got[k].numpy(), want[k]) <= 2, (name, k)


def _unflat(flat):
    out: dict = {}
    for key, x in flat.items():
        d = out
        *head, last = key.split(".")
        for h in head:
            d = d.setdefault(h, {})
        d[last] = x
    return out


def test_global_norm_and_clip():
    rng = np.random.default_rng(3)
    g = _tree(rng, SHAPES, 2.0)
    tg = {k: torch.from_numpy(x) for k, x in _flat(g).items()}
    want = float(JA.global_norm(jax.tree.map(jnp.asarray, g)))
    assert abs(float(PA.global_norm(tg)) - want) <= 1e-6 * want
    jclip, jn = JA.clip_by_global_norm(jax.tree.map(jnp.asarray, g), 1.0)
    pclip, pn = PA.clip_by_global_norm(tg, 1.0)
    assert abs(float(pn) - float(jn)) <= 1e-6 * float(jn)
    for k, x in _flat(jax.tree.map(np.asarray, jclip)).items():
        assert _ulps_of_max(pclip[k].numpy(), x) <= 2, k
    # the scale multiplies every gradient, also when it is 1
    same, _ = PA.clip_by_global_norm(tg, 1e9)
    assert all(torch.equal(same[k], tg[k]) and same[k] is not tg[k]
               for k in tg)


def test_init_state_mirrors_the_parameters():
    params = {"a": torch.ones(3, 2), "b": torch.ones(4, dtype=torch.bfloat16)}
    st = PA.init_state(params)
    assert set(st["m"]) == set(st["v"]) == set(params)
    assert all(t.dtype == torch.float32 and not t.any()
               for d in (st["m"], st["v"]) for t in d.values())
    assert st["step"].dtype == torch.int32 and int(st["step"]) == 0


# ---------------------------------------------------------------- compress
def _ties(rng):
    g = rng.choice(np.float32([-2, -1, 0, 1, 2, 3]), (64, 32)).astype(
        np.float32)
    g[3, 5] = -0.0
    return g


@pytest.mark.parametrize("kind", ["normal", "ties"])
def test_topk_sparsify_and_densify(rng, kind):
    g = rng.standard_normal((64, 32)).astype(np.float32) \
        if kind == "normal" else _ties(rng)
    for k in (1, 128, 700, 2048):
        jv, ji, jr = JCMP.topk_sparsify(jnp.asarray(g), k)
        pv, pi, pr = PCMP.topk_sparsify(torch.from_numpy(g), k)
        assert pi.dtype == torch.int32
        assert np.array_equal(pi.numpy(), np.asarray(ji)), k
        assert np.array_equal(pv.numpy(), np.asarray(jv))
        assert np.array_equal(pr.numpy(), np.asarray(jr))
        jd = JCMP.densify(jv, ji, g.shape)
        pd = PCMP.densify(pv, pi, g.shape)
        assert np.array_equal(pd.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(pd.numpy() + pr.numpy(), g)


@pytest.mark.parametrize("r", [1, 3, 4])
def test_sparse_allreduce_over_a_wide_mesh(rng, r):
    grads = [rng.standard_normal((32, 16)).astype(np.float32)
             for _ in range(r)]
    res = [rng.standard_normal((32, 16)).astype(np.float32) * 0.1
           for _ in range(r)]
    mesh = WideMesh(["cpu"] * r)
    red, new_res = PCMP.sparse_allreduce(
        [torch.from_numpy(x) for x in grads], mesh, k=64,
        residuals=[torch.from_numpy(x) for x in res])
    vals, idx = [], []
    for x, e in zip(grads, res):
        v, i, jr = JCMP.topk_sparsify(jnp.asarray(x) + jnp.asarray(e), 64)
        vals.append(v)
        idx.append(i)
        assert np.array_equal(new_res[len(vals) - 1].numpy(),
                              np.asarray(jr))
    want = np.asarray(JCMP.densify(jnp.concatenate(vals),
                                   jnp.concatenate(idx), (32, 16)) / r)
    assert red.device == mesh.devices[0]
    assert _ulps_of_max(red.numpy(), want) <= 1
    with pytest.raises(ValueError, match="replicas"):
        PCMP.sparse_allreduce([torch.from_numpy(grads[0])] * (r + 1), mesh, 8)


def test_sparse_allreduce_against_shard_map(rng):
    """R = 1: the JAX function itself, under shard_map over one device."""
    from jax.sharding import PartitionSpec as P
    g = rng.standard_normal((256,)).astype(np.float32)
    mesh = jax.make_mesh((1,), ("dp",))

    def f(gl):
        return JCMP.sparse_allreduce(gl, "dp", k=64)

    if hasattr(jax, "shard_map"):
        smap = jax.shard_map(f, mesh=mesh, in_specs=P(),
                             out_specs=(P(), P()), check_vma=False)
    else:
        from jax.experimental.shard_map import shard_map
        smap = shard_map(f, mesh=mesh, in_specs=P(), out_specs=(P(), P()),
                         check_rep=False)
    jred, jres = jax.jit(smap)(jnp.asarray(g))
    red, res = PCMP.sparse_allreduce([torch.from_numpy(g)],
                                     WideMesh(["cpu"]), k=64)
    assert np.array_equal(red.numpy(), np.asarray(jred))
    assert np.array_equal(res[0].numpy(), np.asarray(jres))


def test_wire_bytes_and_coordinate_bitmap(rng):
    for idx in (np.sort(rng.choice(1 << 20, 4096, replace=False)),
                np.arange(70_000, 90_000),
                np.array([5], np.int64)):
        assert PCMP.wire_bytes_sparse(idx) == JCMP.wire_bytes_sparse(idx)
        assert PCMP.wire_bytes_sparse(torch.from_numpy(idx)) == \
            JCMP.wire_bytes_sparse(idx)
        bm = PCMP.coordinate_bitmap(idx)
        assert bm.cardinality == len(idx)
        assert np.array_equal(bm.to_array(),
                              JCMP.coordinate_bitmap(idx).to_array())
    assert PCMP.wire_bytes_dense(1 << 20) == JCMP.wire_bytes_dense(1 << 20)

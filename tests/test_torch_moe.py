"""The port's Mixture of Experts (``repro_torch.models.mlp.MoE`` / ``moe``)
and the routing half of ``repro_torch.serve.telemetry`` against the JAX
package's ``repro.models.mlp.moe`` and ``repro.serve.telemetry``, on the
reduced mixtral config (d 128, 4 experts top-2, ff 256) with the JAX
parameters loaded into the port's module, and the same seeded inputs.

Both dispatches, float32 and bfloat16: ``expert_idx`` and
``dropped_fraction`` equal, ``router_aux`` within 1e-6 (a float32 mean and
scatter-add of the same probabilities, summed in another order), and the
outputs within 1e-5 in float32 (measured 1.2e-6: summation order) and
within atol = rtol = 2^-6 in bfloat16 (measured 2^-6 at outputs up to 2.3,
one bf16 ulp there: the bf16 expert products sum their float32 terms in
another order in XLA and PyTorch and round apart, and the next product
carries that ulp).  A capacity that drops, a decode-shaped (4, 1, d) call
at capacity 1 with two tokens on one expert, and router ties, which go to
the lower index as ``jax.lax.top_k`` sends them.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
from repro.models import mlp as JM
from repro.serve import telemetry as jtel
from repro_torch import configs as C
from repro_torch.models.mlp import MoE, moe, top_k
from repro_torch.serve import telemetry as tel

Y_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -6}


def _configs(dtype="float32", **kw):
    jc = dataclasses.replace(JC.get_config("mixtral_8x7b", reduced=True),
                             compute_dtype=dtype, **kw)
    pc = dataclasses.replace(C.get_config("mixtral_8x7b", reduced=True),
                             compute_dtype=dtype, **kw)
    return jc, pc


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flat(v, key + "."))
        else:
            out[key] = torch.from_numpy(np.array(v, np.float32))
    return out


def _pair(jc, pc, seed=3, router=None):
    """JAX MoE parameters and the port's module with the same weights
    (``router``: a replacement router matrix)."""
    jp = JM.moe_params(jc, jax.random.key(seed))
    if router is not None:
        jp = dict(jp, router=jnp.asarray(router))
    p = MoE(pc, getattr(torch, pc.compute_dtype), "cpu", None)
    p.load_state_dict(_flat(jp))
    return jp, p


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _run(jc, pc, jp, p, x):
    jy, jm = JM.moe(jnp.asarray(x, jc.compute_dtype), jp, jc)
    tx = torch.from_numpy(x).to(getattr(torch, pc.compute_dtype))
    y, m = p(tx)
    assert y.dtype == tx.dtype and y.shape == tx.shape
    return (jy, jm), (y, m)


def _same(jout, pout, dtype):
    (jy, jm), (y, m) = jout, pout
    assert np.array_equal(m["expert_idx"].numpy(),
                          np.asarray(jm["expert_idx"]))
    assert float(m["dropped_fraction"]) == float(jm["dropped_fraction"])
    np.testing.assert_allclose(float(m["router_aux"]),
                               float(jm["router_aux"]), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(_np(y), _np(jy), atol=Y_TOL[dtype],
                               rtol=Y_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dispatch", ["dense", "scatter"])
def test_moe_matches_jax(rng, dispatch, dtype):
    jc, pc = _configs(dtype, moe_dispatch=dispatch)
    jp, p = _pair(jc, pc)
    x = rng.standard_normal((2, 96, jc.d_model)).astype(np.float32)
    jout, pout = _run(jc, pc, jp, p, x)
    _same(jout, pout, dtype)
    assert float(pout[1]["dropped_fraction"]) == 0.0 or dispatch == "scatter"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scatter_drops_past_capacity(rng, dtype):
    """capacity_factor 0.5: cap = round(0.5 * 96 * 2 / 4) = 24 slots an
    expert for 48 choices on average, so a quarter or more are dropped;
    the same ones in both packages."""
    jc, pc = _configs(dtype, capacity_factor=0.5)
    jp, p = _pair(jc, pc, seed=4)
    x = rng.standard_normal((1, 96, jc.d_model)).astype(np.float32)
    jout, pout = _run(jc, pc, jp, p, x)
    _same(jout, pout, dtype)
    assert float(pout[1]["dropped_fraction"]) >= 0.25


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_capacity_one_collision(rng, dtype):
    """Jamba's decode shape: B = 4 tokens, top-2 of 16 experts, capacity
    min(max(1, round(1.25 * 4 * 2 / 16)), 4) = 1.  Tokens 0 and 2 are the
    same vector, so they choose the same two experts and token 2's
    choices are dropped (the token-major cumulative position)."""
    jc, pc = _configs(dtype, n_experts=16)
    jp, p = _pair(jc, pc, seed=5)
    x = rng.standard_normal((4, 1, jc.d_model)).astype(np.float32)
    x[2] = x[0]
    jout, pout = _run(jc, pc, jp, p, x)
    _same(jout, pout, dtype)
    idx = pout[1]["expert_idx"][:, 0]
    assert torch.equal(idx[0], idx[2])
    assert float(pout[1]["dropped_fraction"]) >= 2 / 8
    # token 2 lost both its choices: its output is exactly 0
    assert bool((pout[0][2] == 0).all())


@pytest.mark.parametrize("dispatch", ["dense", "scatter"])
def test_router_ties_go_to_the_lower_index(rng, dispatch):
    """Router columns 1, 2 and 3 equal and column 0 their negation: each
    token ties experts 1-3 exactly, and takes (1, 2) or (0, 1), as
    ``jax.lax.top_k`` does."""
    jc, pc = _configs(moe_dispatch=dispatch)
    col = rng.standard_normal(jc.d_model).astype(np.float32) * 0.2
    router = np.stack([-col, col, col, col], axis=1)
    jp, p = _pair(jc, pc, seed=6, router=router)
    x = rng.standard_normal((1, 40, jc.d_model)).astype(np.float32)
    jout, pout = _run(jc, pc, jp, p, x)
    _same(jout, pout, "float32")
    got = {tuple(r) for r in pout[1]["expert_idx"][0].tolist()}
    assert got <= {(1, 2), (0, 1)} and len(got) == 2


def test_top_k_ties_match_jax():
    x = np.random.default_rng(2).integers(0, 3, (200, 16)).astype(np.float32)
    for k in (1, 2, 5, 16):
        w, idx = top_k(torch.from_numpy(x), k)
        jw, jidx = jax.lax.top_k(jnp.asarray(x), k)
        assert np.array_equal(idx.numpy(), np.asarray(jidx))
        assert np.array_equal(w.numpy(), np.asarray(jw))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_shared_experts_match_jax(rng, dtype):
    """n_shared_experts = 2 (DeepSeek-style): the nested ``shared`` keys
    load and the shared SwiGLU adds to the routed output as in JAX."""
    jc, pc = _configs(dtype, n_shared_experts=2)
    jp, p = _pair(jc, pc, seed=7)
    assert {"shared.w_gate", "shared.w_up", "shared.w_down"} <= set(
        p.state_dict())
    x = rng.standard_normal((2, 32, jc.d_model)).astype(np.float32)
    _same(*_run(jc, pc, jp, p, x), dtype)


def test_moe_function_and_module_agree(rng):
    jc, pc = _configs()
    _, p = _pair(jc, pc)
    x = torch.from_numpy(rng.standard_normal((2, 8, jc.d_model)).astype(
        np.float32))
    y, m = moe(x, p, pc)
    y2, m2 = p(x)
    assert torch.equal(y, y2) and torch.equal(m["expert_idx"],
                                              m2["expert_idx"])


# ------------------------------------------------------------ telemetry
def _routes(rng):
    """expert_idx of one MoE call on 256 tokens, and a second call's on
    the same tokens after the router is perturbed."""
    jc, pc = _configs()
    jp, p = _pair(jc, pc)
    x = torch.from_numpy(rng.standard_normal((1, 256, jc.d_model)).astype(
        np.float32))
    first = p(x)[1]["expert_idx"].reshape(-1, 2)
    with torch.no_grad():
        p.router.add_(torch.from_numpy(
            rng.standard_normal(p.router.shape).astype(np.float32) * 0.05))
    second = p(x)[1]["expert_idx"].reshape(-1, 2)
    return jc.n_experts, first, second


def test_routing_sets_match_jax(rng):
    e, first, _ = _routes(rng)
    sets = tel.routing_sets(first, e)
    jsets = jtel.routing_sets(first.numpy(), e)
    assert len(sets) == len(jsets) == e
    for a, b in zip(sets, jsets):
        assert np.array_equal(a.to_array(), np.asarray(b.to_array()))
    # numpy input gives the same sets
    assert all(a == b for a, b in zip(sets, tel.routing_sets(
        first.numpy(), e)))


def test_routing_statistics_match_jax(rng):
    e, first, second = _routes(rng)
    sets, later = tel.routing_sets(first, e), tel.routing_sets(second, e)
    jsets = jtel.routing_sets(first.numpy(), e)
    jlater = jtel.routing_sets(second.numpy(), e)
    assert tel.load_balance_stats(sets) == jtel.load_balance_stats(jsets)
    assert np.array_equal(tel.expert_overlap_matrix(sets, device="cpu"),
                          jtel.expert_overlap_matrix(jsets))
    drift = tel.routing_drift(sets, later, device="cpu")
    assert np.array_equal(drift, jtel.routing_drift(jsets, jlater))
    assert drift.max() > 0 and np.array_equal(
        tel.routing_drift(sets, sets, device="cpu"), np.zeros(e))


def test_routing_counts_need_a_device_without_a_gpu(rng):
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a GPU")
    e, first, _ = _routes(rng)
    sets = tel.routing_sets(first, e)
    with pytest.raises(RuntimeError, match="CUDA"):
        tel.expert_overlap_matrix(sets)

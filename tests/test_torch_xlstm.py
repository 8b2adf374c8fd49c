"""The port's xLSTM mixers (``repro_torch.models.ssm`` ``MLSTM`` and
``SLSTM``) and xLSTM-350M against the JAX package's, with the reduced
``xlstm_350m`` config (mLSTM and sLSTM blocks with ffn ``none``) and the
JAX weights carried across.

The reduced config sets no ``xlstm_chunk``, so JAX's ``mlstm_train`` takes
its per-token scan; the chunkwise-parallel route runs only where
``xlstm_chunk`` is set, S is a multiple of it and longer, so the tests
force it with ``xlstm_chunk=16`` on 64 tokens.

Tolerances.  Modules against JAX run op by op, and the whole model against
JAX compiled with ``allow_excess_precision`` off: float32 1e-5 on the
modules' outputs and states, relative to the largest magnitude for the
mLSTM's C and n (which grow with the sequence); the whole model's logits
at ``tests/test_torch_hybrid.py``'s tolerances (1e-4 / 0.125) and its
recurrent states at 1e-4 / 0.0625: in float32 the jitted JAX scan fuses
its body, and 64 steps of two sLSTM layers carry that rounding to 1.4e-5
on values near 1 (measured), past the 1e-5 that a cache written once
meets.  bfloat16 modules: outputs within one bf16 ulp of their
row's largest value; the float32 states within 2e-3 of the largest
magnitude (the bf16 projections feed them, each side rounding once).  The
sLSTM's GeLU is JAX's tanh form op for op (``mlp.gelu_tanh``) and the
mLSTM's SiLU XLA's 1 / (1 + exp(-x)) (``mlp.silu``), both in the compute
dtype; the float32 gates are PyTorch's fused ``sigmoid`` and
``logsigmoid``, within 2.3e-7 relative of JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels import ops as jops
from repro.models import ssm as JS
from repro.models import transformer as JT
from repro_torch.convert import params_from_jax
from repro_torch.models import ssm
from repro_torch.models.transformer import Transformer
from test_torch_hybrid import (
    CACHE_TOL, LOGIT_TOL, _close, _configs, _exact, _np, _row_ulps,
    _states_close,
)

ARCH = "xlstm_350m"
B, S, S_MAX, STEPS = 2, 64, 128, 4
STATE_TOL = {"float32": 1e-4, "bfloat16": CACHE_TOL["bfloat16"]}


def _module(kind, dtype, **kw):
    jc, pc = _configs(ARCH, dtype, **kw)
    jp = getattr(JS, f"{kind}_params")(jc, jax.random.key(4))
    p = (ssm.MLSTM if kind == "mlstm" else ssm.SLSTM)(
        pc, getattr(torch, dtype), "cpu", None)
    p.load_state_dict({k: torch.from_numpy(np.array(v))
                       for k, v in jp.items()})
    return jc, pc, jp, p


def _out_close(got, want, dtype):
    if dtype == "float32":
        _close(got, want, 1e-5)
    else:
        assert _row_ulps(got, want) <= 1.0


def _state_close(got: dict, want: dict, dtype):
    """Each float32 state tensor within 1e-5 (float32) or 2e-3 (bfloat16)
    of its largest magnitude (at least 1)."""
    assert set(got) == set(want)
    tol = 1e-5 if dtype == "float32" else 2e-3
    for key, w in want.items():
        g, w = _np(got[key]), _np(w)
        assert got[key].dtype == torch.float32, key
        top = max(float(np.abs(w).max()), 1.0)
        np.testing.assert_allclose(g, w, atol=tol * top, rtol=0, err_msg=key)


def _x(rng, shape, dtype):
    x = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(x, dtype), torch.from_numpy(x).to(getattr(torch,
                                                                 dtype))


# ---------------------------------------------------------------- modules
@pytest.mark.parametrize("chunk", [0, 16])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlstm_train_matches_jax(rng, dtype, chunk):
    """Both routes of ``mlstm_train``: the per-token scan (chunk 0) and the
    chunkwise-parallel form (chunk 16 over 64 tokens), output and the
    final C, n and m."""
    jc, pc, jp, p = _module("mlstm", dtype, xlstm_chunk=chunk)
    jx, tx = _x(rng, (B, S, jc.d_model), dtype)
    want, wst = JS.mlstm_train(jx, jp, jc, return_state=True)
    got, st = ssm.mlstm_train(tx, p, pc, return_state=True)
    assert got.dtype == tx.dtype
    _out_close(got, want, dtype)
    _state_close(st, wst, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlstm_decode_matches_jax(rng, dtype):
    """Two steps from the initial state (m = -1e30) and from the state
    after a prompt."""
    jc, pc, jp, p = _module("mlstm", dtype)
    jx, tx = _x(rng, (B, 8, jc.d_model), dtype)
    _, wst = JS.mlstm_train(jx, jp, jc, return_state=True)
    _, st = ssm.mlstm_train(tx, p, pc, return_state=True)
    for start_w, start_p in ((JS.mlstm_init_state(jc, B, jnp.float32),
                              ssm.mlstm_init_state(pc, B, "cpu")),
                             (wst, st)):
        jt, tt = _x(rng, (B, jc.d_model), dtype)
        want, w_next = JS.mlstm_decode(jt, jp, jc, start_w)
        got, p_next = ssm.mlstm_decode(tt, p, pc, start_p)
        _out_close(got, want, dtype)
        _state_close(p_next, w_next, dtype)


@pytest.mark.parametrize("chunk", [8, 16, 32])
def test_mlstm_chunked_equals_the_recurrence(rng, chunk):
    """The port's chunked form against its own per-token recurrence on the
    same float32 inputs, from a state that is not the initial one: h and
    the final C, n, m within 1e-5 of the largest magnitude (the check
    ``chip_smoke.py`` phase 14 runs at full width)."""
    _, pc, _, p = _module("mlstm", "float32")
    _, tx = _x(rng, (B, 8 + S, pc.d_model), "float32")
    di = pc.ssm_expand * pc.d_model
    q, k, v, i_pre, f_pre = ssm.mlstm_inputs((tx @ p.up)[..., :di], p, pc)
    _, st0 = ssm.mlstm_steps(q[:, :8], k[:, :8], v[:, :8], i_pre[:, :8],
                             f_pre[:, :8], ssm.mlstm_init_state(pc, B, "cpu"))
    rest = [t[:, 8:] for t in (q, k, v, i_pre, f_pre)]
    h_c, st_c = ssm.mlstm_chunked(*rest, st0, chunk)
    h_s, st_s = ssm.mlstm_steps(*rest, st0)
    _state_close({"h": h_c, **st_c}, {"h": h_s, **st_s}, "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_slstm_train_matches_jax(rng, dtype):
    jc, pc, jp, p = _module("slstm", dtype)
    jx, tx = _x(rng, (B, S, jc.d_model), dtype)
    want, wst = JS.slstm_train(jx, jp, jc, return_state=True)
    got, st = ssm.slstm_train(tx, p, pc, return_state=True)
    assert got.dtype == tx.dtype
    _out_close(got, want, dtype)
    _state_close(st, wst, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_slstm_decode_matches_jax(rng, dtype):
    jc, pc, jp, p = _module("slstm", dtype)
    jx, tx = _x(rng, (B, 8, jc.d_model), dtype)
    _, wst = JS.slstm_train(jx, jp, jc, return_state=True)
    _, st = ssm.slstm_train(tx, p, pc, return_state=True)
    for start_w, start_p in ((JS.slstm_init_state(jc, B, jnp.float32),
                              ssm.slstm_init_state(pc, B, "cpu")),
                             (wst, st)):
        jt, tt = _x(rng, (B, jc.d_model), dtype)
        want, w_next = JS.slstm_decode(jt, jp, jc, start_w)
        got, p_next = ssm.slstm_decode(tt, p, pc, start_p)
        _out_close(got, want, dtype)
        _state_close(p_next, w_next, dtype)


@pytest.mark.parametrize("mine,theirs", [
    (torch.sigmoid, jax.nn.sigmoid), (F.logsigmoid, jax.nn.log_sigmoid)])
def test_gates_are_jax_gates(rng, mine, theirs):
    """The float32 gates the xLSTM steps use (PyTorch's fused ops) against
    ``jax.nn``'s over a range that reaches both tails: within 1e-6
    relative (measured 2.3e-7; XLA expands them into several ops that
    round apart in the last bits)."""
    x = (rng.standard_normal(20_000) * 12).astype(np.float32)
    np.testing.assert_allclose(mine(torch.from_numpy(x)).numpy(),
                               np.asarray(theirs(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-30)


# ------------------------------------------------------------ whole model
@pytest.mark.parametrize("chunk", [0, 16])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_teacher_forced_decode(dtype, chunk):
    """xLSTM-350M reduced (mLSTM, sLSTM, ffn none), the mLSTM prefill on
    each route: a prefill, then teacher-forced decode steps; logits and
    every layer's C, n, m / c, n, h, m after each."""
    jc, pc = _configs(ARCH, dtype, xlstm_chunk=chunk)
    params = JT.init_params(jc, jax.random.key(1))
    model = Transformer(pc, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    toks = np.random.default_rng(7).integers(
        0, jc.vocab, (B, S + STEPS)).astype(np.int32)
    old = jops._DEFAULT
    jops.set_default_backend("pallas")
    try:
        prompt = jnp.asarray(toks[:, :S])
        jl, jst = _exact(lambda p, t: JT.prefill(
            p, {"tokens": t}, jc, s_max=S_MAX), params, prompt)(params,
                                                                prompt)
        pl, pst = model.prefill(torch.from_numpy(toks[:, :S]), s_max=S_MAX)
        _close(pl, jl, LOGIT_TOL[dtype])
        _states_close(jst, pst, jc, STATE_TOL[dtype])
        step = _exact(lambda p, st, t: JT.decode_step(p, st, t, jc), params,
                      jst, jnp.asarray(toks[:, S]))
        for t in range(STEPS):
            jl, jst = step(params, jst, jnp.asarray(toks[:, S + t]))
            pl, pst = model.decode_step(pst, torch.from_numpy(toks[:, S + t]))
            _close(pl, jl, LOGIT_TOL[dtype])
            _states_close(jst, pst, jc, STATE_TOL[dtype])
        assert pst.pos.tolist() == [S + STEPS] * B
    finally:
        jops.set_default_backend(old)


def test_state_dict_covers_the_jax_tree():
    """Every key comes from the JAX tree and back; a block with ffn
    ``none`` has no ``ln2`` or ``ffn``; the gate biases, the norm scale
    and the sLSTM recurrence stay float32."""
    jc, pc = _configs(ARCH, "bfloat16")
    tree = jax.tree.map(np.asarray, JT.init_params(jc, jax.random.key(0)))
    model = Transformer(pc, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    sd = model.state_dict()
    assert set(params_from_jax(tree)) == set(sd)
    assert not any(".ln2." in k or ".ffn." in k for k in sd)
    f32 = ("scale", "mixer.bi", "mixer.bf", "mixer.ln", "mixer.r", "mixer.b")
    for key, t in sd.items():
        assert t.dtype == (torch.float32 if key.endswith(f32)
                           else torch.bfloat16), key


def test_decode_step_reruns_from_the_same_state():
    """The recurrent mixers return new state: a second step from the same
    state gives the same logits and the first state is left as it was."""
    _, pc = _configs(ARCH, "float32")
    model = Transformer(pc, device="cpu",
                        generator=torch.Generator().manual_seed(3))
    toks = torch.from_numpy(np.random.default_rng(8).integers(
        0, pc.vocab, (B, 17)).astype(np.int32))
    _, st = model.prefill(toks[:, :16])
    before = [{k: v.clone() for k, v in ls.items()} for ls in st.layers]
    a, st1 = model.decode_step(st, toks[:, 16])
    b, _ = model.decode_step(st, toks[:, 16])
    assert torch.equal(a, b)
    for ls, old, new in zip(st.layers, before, st1.layers, strict=True):
        assert all(torch.equal(ls[k], old[k]) for k in ls)
        assert not torch.equal(new["m"], old["m"]) or \
            not torch.equal(new["n"], old["n"])


def test_launcher_serves_the_reduced_config(capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", "xlstm-350m", "--reduced", "--device", "cpu",
                "--batch", "2", "--new-tokens", "3"])
    out = capsys.readouterr().out.splitlines()
    assert len([ln for ln in out if ln.startswith("seq")]) == 2

"""The port's model against the JAX package's on the other configurations
``models.transformer.check_supported`` accepts: reduced ``qwen2_5_3b`` (qkv
bias, tied embeddings), ``stablelm_3b`` (layernorm), ``qwen3_14b``
(qk-norm) and its Roaring-sparse variant (every layer global, so each
decode step takes the block-sparse decode attention; built on the reduced
config with 10 query heads over 2 KV heads, the full variant's group of 5
query heads a KV head), in float32 and bfloat16.

Each case runs ``tests/test_torch_model.py``'s
``test_prefill_and_teacher_forced_decode``: the same JAX weights carried
across by ``convert.params_from_jax``, a prefill of 192 tokens, then 8
teacher-forced decode steps, logits and KV caches compared after every
step with that file's tolerances and for the same reasons (float32: 1e-4
on logits, 1e-5 on caches; bfloat16: 0.125 and 0.0625).  The JAX side
runs under ``set_default_backend("pallas")``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
from repro.configs import qwen3_14b as jq3
from repro.kernels import ops as jops
from repro.models import transformer as JT
from repro_torch import configs as C
from repro_torch.configs import qwen3_14b as tq3
from repro_torch.convert import params_from_jax
from repro_torch.models.transformer import Transformer, check_supported

B, S, S_MAX, STEPS = 2, 192, 512, 8
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 0.125}
CACHE_TOL = {"float32": 1e-5, "bfloat16": 0.0625}
ARCHS = ("qwen2_5_3b", "stablelm_3b", "qwen3_14b", "qwen3_14b_sparse")


def _sparse(mod):
    return dataclasses.replace(
        mod.reduced(), name="qwen3-14b+roaring-sparse-reduced", n_heads=10,
        pattern=(("global", "mlp"),), roaring_sparse_global=True)


def _configs(arch, dtype):
    if arch == "qwen3_14b_sparse":
        jc, pc = _sparse(jq3), _sparse(tq3)
    else:
        jc = JC.get_config(arch, reduced=True)
        pc = C.get_config(arch, reduced=True)
    return (dataclasses.replace(jc, compute_dtype=dtype),
            dataclasses.replace(pc, compute_dtype=dtype))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_teacher_forced_decode(arch, dtype):
    jc, pc = _configs(arch, dtype)
    check_supported(pc)
    params = JT.init_params(jc, jax.random.key(1))
    model = Transformer(pc, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    toks = np.random.default_rng(7).integers(
        0, jc.vocab, (B, S + STEPS)).astype(np.int32)
    # blocks 0 and 1 visible (the prompt and the decoded tokens), block 3
    # set past every kv_len
    jwords = np.full((B, 1), 0b1011, np.uint32)
    twords = torch.from_numpy(jwords.view(np.int32))
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
        step = jax.jit(lambda p, st, t, m: JT.decode_step(p, st, t, jc, m))
        for t in range(STEPS):
            jl, jst = step(params, jst, jnp.asarray(toks[:, S + t]),
                           jnp.asarray(jwords))
            pl, pst = model.decode_step(pst, torch.from_numpy(toks[:, S + t]),
                                        twords)
            _close(pl, jl, LOGIT_TOL[dtype])
        for i in range(jc.n_layers):
            r, pi = divmod(i, n_pat)
            for name in ("k", "v"):
                _close(pst.layers[i][name], jst["pattern"][pi][name][:, r],
                       CACHE_TOL[dtype])
        assert pst.pos.tolist() == [S + STEPS] * B
    finally:
        jops.set_default_backend(old)

"""The port's training loss and its backward against the JAX package's:
``Transformer.loss_and_metrics`` of float32 masters (``param_dtype=
"float32"``) and its gradients by autograd, against
``jax.value_and_grad(T.loss_and_metrics)``, for reduced ``qwen2_5_3b``
(QKV bias, a tied embedding, GQA) and reduced ``gemma2_27b`` (local /
global layers, softcaps, post-norms, a scaled embedding, GeGLU) in float32
and bfloat16 compute, and reduced ``stablelm_3b`` (layernorm) in float32.  The
JAX parameters come across through ``convert.params_from_jax``; its
gradient tree maps onto the port's parameter names the same way.  Inputs:
B = 2 sequences of 128 tokens (two query blocks of 64) from a seeded numpy
generator, the first 5 labels of one row -1 (masked).  JAX's function is
compiled once per case (a module fixture) with XLA's
``allow_excess_precision`` off, as ``tests/test_torch_hybrid.py`` compiles
it, so every bfloat16 op rounds as its dtypes say.

Tolerances.  Float32: the loss within 1e-5 relative, each gradient leaf
within 1e-4 of that leaf's largest magnitude (measured: the loss within
1.5e-7, every leaf within 2.0e-6: summation order only).  bfloat16: the
loss within 1e-4 relative (measured 1.6e-5) and each leaf within 0.0625
of its largest magnitude (measured 0.0256, a QKV bias: the backward's bf16
products and sums round apart in XLA and PyTorch, a few bf16 ulps of the
leaf's largest gradient; 4x would be 0.1026).  Gemma2-27B in bfloat16:
the loss within 7.4e-5 relative and every leaf within 0.0150 (the first
layer's key projection), under the same tolerances: its softcaps, GeGLU
and sqrt(d_model) embedding scale round as JAX's do.

The tied embedding: JAX's compiled backward converts each use's bfloat16
cotangent (the gather's and the logits') to float32 and adds them there
(``add_any`` of two converts in its HLO), and the port's two per-use casts
do the same; one bfloat16 cast read twice would sum them in bfloat16
first (measured 0.0111 against 0.0098 for the embedding).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
from repro.models import transformer as JT
from repro_torch import configs as C
from repro_torch.convert import params_from_jax
from repro_torch.models.transformer import Transformer
from test_torch_hybrid import _exact

B, S = 2, 128
CASES = {"qwen2_5_3b-float32": ("qwen2_5_3b", "float32"),
         "qwen2_5_3b-bfloat16": ("qwen2_5_3b", "bfloat16"),
         "gemma2_27b-float32": ("gemma2_27b", "float32"),
         "gemma2_27b-bfloat16": ("gemma2_27b", "bfloat16"),
         "stablelm_3b-float32": ("stablelm_3b", "float32")}
LOSS_TOL = {"float32": 1e-5, "bfloat16": 1e-4}
LEAF_TOL = {"float32": 1e-4, "bfloat16": 0.0625}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small shapes: the suite runs several
    workers on the same cores, and torch's default of a thread a core
    oversubscribes them (30 small train steps took 121 s so, 1 s alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(arch, dtype, **kw):
    kw = dict(dict(compute_dtype=dtype, remat="none"), **kw)
    return (dataclasses.replace(JC.get_config(arch, reduced=True), **kw),
            dataclasses.replace(C.get_config(arch, reduced=True), **kw))


def _batch(vocab, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (B, S + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, :5] = -1
    return {"tokens": toks[:, :-1], "labels": labels}


def _model(pc, jparams):
    m = Transformer(pc, device="cpu", param_dtype="float32")
    m.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams)))
    return m.requires_grad_(True)


def _port_grads(m, batch):
    loss, metrics = m.loss_and_metrics(
        {k: torch.from_numpy(v) for k, v in batch.items()})
    params = dict(m.named_parameters())
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss.detach(), metrics, dict(zip(params, grads))


@pytest.fixture(scope="module")
def jax_cases():
    """Each case's JAX loss, metrics and gradients (as the port's state
    dict), compiled once."""
    cache = {}

    def get(case):
        if case not in cache:
            arch, dtype = CASES[case]
            jc, pc = _configs(arch, dtype)
            params = JT.init_params(jc, jax.random.key(3))
            batch = _batch(jc.vocab)
            jb = {k: jnp.asarray(v) for k, v in batch.items()}
            fn = jax.value_and_grad(
                lambda p, b: JT.loss_and_metrics(p, b, jc), has_aux=True)
            (loss, metrics), grads = _exact(fn, params, jb)(params, jb)
            cache[case] = dict(
                jc=jc, pc=pc, params=params, batch=batch,
                loss=float(loss), metrics=jax.tree.map(np.asarray, metrics),
                grads=params_from_jax(jax.tree.map(
                    lambda a: np.asarray(a, np.float32), grads)))
        return cache[case]
    return get


def _leaf_errors(got: dict, want: dict) -> dict:
    assert set(got) == set(want)
    return {k: float((got[k].float() - want[k]).abs().max()
                     / max(float(want[k].abs().max()), 1e-30))
            for k in want}


@pytest.mark.parametrize("case", list(CASES))
def test_loss_and_every_gradient_leaf(jax_cases, case):
    c = jax_cases(case)
    dtype = CASES[case][1]
    m = _model(c["pc"], c["params"])
    loss, metrics, grads = _port_grads(m, c["batch"])
    assert abs(float(loss) - c["loss"]) <= LOSS_TOL[dtype] * abs(c["loss"])
    assert int(metrics["tokens"]) == int(c["metrics"]["tokens"]) == B * S - 5
    assert float(metrics["router_aux"]) == 0.0
    errs = _leaf_errors(grads, c["grads"])
    worst = max(errs, key=errs.get)
    assert errs[worst] <= LEAF_TOL[dtype], (worst, errs[worst])
    # every master is float32 and so is its gradient
    assert all(g.dtype == torch.float32 for g in grads.values())


def test_ce_chunk_matches_the_whole_sequence(jax_cases):
    """ce_chunk = 16: eight chunks of the sequence, each its own logits and
    cross entropy, summed in float32: the unchunked loss and gradients
    within float32 summation order."""
    c = jax_cases("qwen2_5_3b-float32")
    _, pc = _configs("qwen2_5_3b", "float32", ce_chunk=16)
    m = _model(pc, c["params"])
    loss, metrics, grads = _port_grads(m, c["batch"])
    assert abs(float(loss) - c["loss"]) <= 1e-5 * abs(c["loss"])
    assert int(metrics["tokens"]) == B * S - 5
    errs = _leaf_errors(grads, c["grads"])
    assert max(errs.values()) <= 1e-4
    _, pc_bad = _configs("qwen2_5_3b", "float32", ce_chunk=48)
    with pytest.raises(ValueError, match="ce_chunk"):
        _model(pc_bad, c["params"]).loss_and_metrics(
            {k: torch.from_numpy(v) for k, v in c["batch"].items()})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_remat_gives_the_same_gradients(jax_cases, dtype):
    """remat="block" recomputes each layer in the backward pass
    (torch.utils.checkpoint): loss and gradients bit-equal to remat off."""
    c = jax_cases(f"qwen2_5_3b-{dtype}")
    off = _port_grads(_model(c["pc"], c["params"]), c["batch"])
    _, pc = _configs("qwen2_5_3b", dtype, remat="block")
    on = _port_grads(_model(pc, c["params"]), c["batch"])
    assert torch.equal(on[0], off[0])
    for k, g in off[2].items():
        assert torch.equal(on[2][k], g), k


def test_serving_weights_stay_in_the_compute_dtype(jax_cases):
    """Without param_dtype the model stores matrices in the compute dtype
    (the serving model, unchanged); with float32 masters in bfloat16
    compute the loss is the serving weights' within bf16 rounding of
    nothing: the casts give the same values."""
    c = jax_cases("qwen2_5_3b-bfloat16")
    serve = Transformer(c["pc"], device="cpu")
    serve.load_state_dict(params_from_jax(
        jax.tree.map(np.asarray, c["params"])))
    assert serve.embed.dtype == serve.layers[0].mixer.wq.dtype == \
        torch.bfloat16
    assert not any(p.requires_grad for p in serve.parameters())
    batch = {k: torch.from_numpy(v) for k, v in c["batch"].items()}
    with torch.no_grad():
        a = serve.loss_and_metrics(batch)[0]
        b = _model(c["pc"], c["params"]).loss_and_metrics(batch)[0]
    assert torch.equal(a, b)

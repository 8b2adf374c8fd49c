"""Several bfloat16 train steps of the port against the JAX package's.

The config is ``examples/train_tiny_lm.py``'s: reduced ``qwen2_5_3b``
with ``d_model=256, n_layers=4, d_ff=1024, vocab=2048, n_heads=8,
n_kv_heads=2``, keeping its defaults ``compute_dtype="bfloat16"`` and
``remat="block"``, on float32 masters.  Nothing is cut: its pipeline's
batches of 16 x 128 tokens (4,096 documents, seed 0, the 0.2 quality
filter), 5 steps at lr 1e-3 with the example's AdamW settings (warmup 20,
total 200, weight decay 0.01), and again with a schedule that reaches 1e-3
by step 5 (warmup 5, total 5, weight decay 0.1: ``chip_smoke.py`` phase
15's, where Qwen2.5-3B's first batch rose at full width).

JAX side: ``train_step.make_train_step`` compiled with XLA's
``allow_excess_precision`` off (``_exact`` of ``tests/test_torch_hybrid.
py``), so each bfloat16 op rounds as its dtypes say; the JAX ``Trainer``
jits with XLA's defaults, which keep some bfloat16 sums in float32.  Port
side: ``repro_torch.train.train_step`` on the same parameters carried
across by ``params_from_jax`` and the port's pipeline's batches, which
equal the JAX pipeline's.

Tolerances, from a measurement on this data.  Every step's loss within
4e-4 relative of JAX's (measured 9.5e-5 for the example's schedule, 6.2e-5
for phase 15's) and grad norm within 1.5e-3 relative (measured 3.1e-4 and
3.4e-4): the backward's bfloat16 products and sums round apart in XLA and
PyTorch, as in ``tests/test_torch_train.py``.  After the 5 steps the first
batch's loss, re-evaluated, falls on both sides (8.138 -> 7.500 and ->
6.713) and the two agree within 4e-4 relative (measured 5.6e-5 and
1.4e-5).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
from repro.data.pipeline import RoaringDataPipeline as JPipe
from repro.data.pipeline import quality_filter as jquality
from repro.models import transformer as JT
from repro.optim import adamw as JA
from repro.train import train_step as JTS
from repro_torch import configs as C
from repro_torch.convert import params_from_jax
from repro_torch.data.pipeline import RoaringDataPipeline, quality_filter
from repro_torch.models.transformer import Transformer
from repro_torch.optim import adamw as PA
from repro_torch.train import train_step as PTS
from test_torch_hybrid import _exact

TINY = dict(d_model=256, n_layers=4, d_ff=1024, vocab=2048, n_heads=8,
            n_kv_heads=2)
PIPE = dict(n_docs=4096, seq_len=128, batch_size=16, seed=0)
STEPS = 5
SCHEDULES = {"example": dict(lr=1e-3, warmup_steps=20, total_steps=200,
                             weight_decay=0.01),
             "phase15": dict(lr=1e-3, warmup_steps=5, total_steps=5)}
LOSS_TOL = 4e-4
NORM_TOL = 1.5e-3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    """The configs, JAX's initial parameters and the 5 batches (the JAX
    pipeline's and the port's, which must be equal), made once."""
    jc = dataclasses.replace(JC.get_config("qwen2_5_3b", reduced=True),
                             **TINY)
    pc = dataclasses.replace(C.get_config("qwen2_5_3b", reduced=True),
                             **TINY)
    scores = np.random.default_rng(0).random(PIPE["n_docs"])
    jpipe = JPipe(vocab=jc.vocab, filters={"quality": jquality(scores, 0.2)},
                  **PIPE)
    ppipe = RoaringDataPipeline(
        vocab=pc.vocab, filters={"quality": quality_filter(scores, 0.2)},
        device="cpu", **PIPE)
    batches = []
    for _ in range(STEPS):
        jb, pb = jpipe.next_batch(), ppipe.next_batch()
        for k in ("tokens", "labels", "doc_ids"):
            assert np.array_equal(jb[k], pb[k])
        batches.append({k: pb[k] for k in ("tokens", "labels")})
    return jc, pc, JT.init_params(jc, jax.random.key(0)), batches


def test_tiny_lm_config_defaults(setup):
    jc, pc, _, _ = setup
    for c in (jc, pc):
        assert (c.compute_dtype, c.remat, c.param_dtype) == \
            ("bfloat16", "block", "float32")


@pytest.mark.parametrize("schedule", list(SCHEDULES))
def test_five_bf16_remat_steps_against_jax(setup, schedule):
    jc, pc, params, batches = setup
    opt = SCHEDULES[schedule]
    jbatches = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]
    tbatches = [{k: torch.from_numpy(v) for k, v in b.items()}
                for b in batches]
    jstate = JA.init_state(params)
    jstep = _exact(JTS.make_train_step(jc, JA.AdamWConfig(**opt)), params,
                   jstate, jbatches[0])
    jeval = _exact(JTS.make_eval_step(jc), params, jbatches[0])

    model = Transformer(pc, device="cpu", param_dtype="float32")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    model.requires_grad_(True)
    pstate = PA.init_state(dict(model.named_parameters()))
    pstep = PTS.make_train_step(pc, PA.AdamWConfig(**opt))
    peval = PTS.make_eval_step(pc)

    first = (float(jeval(params, jbatches[0])["loss"]),
             float(peval(model, tbatches[0])["loss"]))
    for jb, tb in zip(jbatches, tbatches, strict=True):
        params, jstate, jm = jstep(params, jstate, jb)
        model, pstate, pm = pstep(model, pstate, tb)
        want, got = float(jm["loss"]), float(pm["loss"])
        assert abs(got - want) <= LOSS_TOL * abs(want), (want, got)
        want, got = float(jm["grad_norm"]), float(pm["grad_norm"])
        assert abs(got - want) <= NORM_TOL * want, (want, got)
        assert float(pm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
    after = (float(jeval(params, jbatches[0])["loss"]),
             float(peval(model, tbatches[0])["loss"]))
    # the first batch's loss moves the same way on both sides: it falls
    assert after[0] < first[0] and after[1] < first[1]
    assert abs(after[1] - after[0]) <= LOSS_TOL * after[0]

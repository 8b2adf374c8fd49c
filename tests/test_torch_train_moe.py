"""The port's training of the Mixture-of-Experts configs against the JAX
package's (helpers and tolerances from ``tests/test_torch_train_families.
py``): ``Transformer.loss_and_metrics`` of float32 masters and its
gradients by autograd against ``jax.value_and_grad(T.loss_and_metrics)``,
the loss, ``router_aux`` and every gradient leaf, at the reduced configs:

* ``mixtral_8x7b`` (ffn ``moe``: the scatter dispatch, which drops choices
  past an expert's capacity into a spare row that gets no gradient, the
  router's gradient through the load-balance loss and the top-k weights),
  float32 and bfloat16;
* ``deepseek_v2_236b`` (a prefix MLA + MLP layer, then MLA + MoE with a
  shared expert), float32;
* a two-layer Jamba pattern, (("mamba", "moe"), ("global", "mlp")) at the
  reduced Jamba widths with ``ssm_chunk`` 32 over S = 128 (four chunks of
  the Mamba scan, each checkpointed), float32 and bfloat16.  The whole
  reduced Jamba (its 8-layer period) is not taken: JAX's one-step train of
  it takes 151 s to compile, past this file's budget.

Float32 tolerances as there (measured: the loss within 7.1e-8, every leaf
within 4.1e-6).  bfloat16 (``BF16``): each limit 4x the measured error of
its case.  The backward's bf16 products round apart in XLA and PyTorch, a
few bf16 ulps of a leaf's largest gradient; the router runs in float32 on
activations an ulp apart, so ``router_aux`` differs too (Mixtral 4.3e-5;
0 in Jamba, whose one MoE layer, the first layer's ffn, reads activations
equal in both packages).
In Mixtral one token of 256 in its second MoE layer flips experts at a
near tie (JAX's probabilities of the pair 6.3e-5 apart): the port follows
JAX's route there (``_TrainRoutes``), and any flip past
``NEAR_TIE`` fails.

Then remat on against off for Mixtral (bit-equal: the dispatch's gather
back adds only the zeros of dropped choices to its one repeated row, and
the routing counts add one constant), and three steps of the port's
``Trainer`` against the JAX ``Trainer`` on reduced Mixtral.
"""

import jax
import numpy as np
import pytest

import repro.configs as JC
from repro.data.pipeline import RoaringDataPipeline as JPipe
from repro.optim.adamw import AdamWConfig as JAdamW
from repro.train.trainer import Trainer as JTrainer
from repro_torch.convert import opt_state_from_jax, params_from_jax
from repro_torch.data.pipeline import RoaringDataPipeline
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.trainer import Trainer
from test_torch_train_families import (  # noqa: F401  (the fixture)
    F32_TOL, _one_thread, check_case, check_remat, configs, jax_case,
)

JAMBA2 = dict(n_layers=2, pattern=(("mamba", "moe"), ("global", "mlp")),
              ssm_chunk=32)
CASES = {
    "mixtral-float32": ("mixtral_8x7b", "float32", {}, "tokens", 128),
    "mixtral-bfloat16": ("mixtral_8x7b", "bfloat16", {}, "tokens", 128),
    "deepseek-float32": ("deepseek_v2_236b", "float32", {}, "tokens", 128),
    "jamba2-float32": ("jamba_v01_52b", "float32", JAMBA2, "tokens", 128),
    "jamba2-bfloat16": ("jamba_v01_52b", "bfloat16", JAMBA2, "tokens", 128),
}
# bfloat16: 4x each case's measured error (the loss and router loss
# relative, the worst leaf of its largest magnitude); measured 0 stays 0
BF16 = {"mixtral-bfloat16": dict(loss=4 * 5.54e-5, aux=4 * 4.26e-5,
                                 leaf=4 * 0.01545),
        "jamba2-bfloat16": dict(loss=4 * 9.73e-6, aux=0.0,
                                leaf=4 * 0.01852)}


@pytest.fixture(scope="module")
def jax_cases():
    cache = {}

    def get(case):
        if case not in cache:
            cache[case] = jax_case(*CASES[case])
        return cache[case]
    return get


@pytest.mark.parametrize("case", list(CASES))
def test_loss_aux_and_every_gradient_leaf(jax_cases, case, monkeypatch):
    dtype = CASES[case][1]
    check_case(jax_cases(case), case, CASES[case][3],
               F32_TOL if dtype == "float32" else BF16[case], monkeypatch)


def test_remat_gives_the_same_gradients(jax_cases):
    """Mixtral (the dispatch's index writes and gathers, the routing
    counts) with remat on and off: bit-equal."""
    case = "mixtral-float32"
    arch, dtype, kw, _, _ = CASES[case]
    check_remat(jax_cases(case), arch, dtype, kw)


OPT = dict(lr=3e-3, warmup_steps=5, total_steps=100, weight_decay=0.0)
PIPE = dict(n_docs=512, seq_len=32, batch_size=4, seed=7)


def test_three_steps_against_the_jax_trainer(tmp_path):
    """Reduced Mixtral, float32 compute, remat off, from the JAX trainer's
    own parameters and the same pipeline seed: each step's loss within
    1e-5 relative, grad norm within 1e-4 relative and lr within 4 float32
    ulps (``tests/test_torch_trainer.py``'s bounds for Qwen2.5-3B); after
    the steps m and v within 2e-4 of each leaf's largest magnitude, and
    every parameter within 11% of the steps' summed learning rates
    (measured 2.7%, in the embedding: AdamW's first steps move an element
    by about lr whatever its gradient's size, so an element whose gradient
    is float32 noise moves apart by a share of lr; 0.9% for Qwen2.5-3B
    over five steps)."""
    jc, pc = configs("mixtral_8x7b", "float32")
    assert JC.get_config("mixtral_8x7b", reduced=True).n_experts == 4
    jt = JTrainer(jc, JAdamW(**OPT), JPipe(vocab=jc.vocab, **PIPE),
                  str(tmp_path / "jax"), ckpt_every=100, async_ckpt=False)
    pt = Trainer(pc, AdamWConfig(**OPT),
                 RoaringDataPipeline(vocab=pc.vocab, device="cpu", **PIPE),
                 str(tmp_path / "port"), ckpt_every=100, async_ckpt=False,
                 device="cpu")
    pt.model.load_state_dict(params_from_jax(
        jax.tree.map(np.asarray, jt.params)))
    want_hist = jt.train(3, log_every=100)
    got = pt.train(3, log_every=100)
    for g, w in zip(got, want_hist, strict=True):
        assert g["step"] == w["step"]
        assert abs(g["loss"] - w["loss"]) <= 1e-5 * abs(w["loss"])
        assert abs(g["grad_norm"] - w["grad_norm"]) <= 1e-4 * w["grad_norm"]
        assert abs(g["lr"] - w["lr"]) <= 4 * np.spacing(np.float32(w["lr"]))
    want = opt_state_from_jax(jax.tree.map(np.asarray, jt.opt_state))
    want["params"] = params_from_jax(jax.tree.map(np.asarray, jt.params))
    assert int(pt.opt_state["step"]) == int(want["step"]) == 3
    moved = sum(w["lr"] for w in want_hist)
    for key, got_t in (("params", pt.params), ("m", pt.opt_state["m"]),
                       ("v", pt.opt_state["v"])):
        assert set(got_t) == set(want[key])
        for k, w in want[key].items():
            err = float((got_t[k].detach() - w).abs().max())
            limit = 0.11 * moved if key == "params" else \
                2e-4 * float(w.abs().max())
            assert err <= limit, (key, k, err)

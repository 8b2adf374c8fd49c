"""The port's training loss and backward for the blocks and frontends past
the attention family, against the JAX package's: ``Transformer.
loss_and_metrics`` of float32 masters and its gradients by autograd,
against ``jax.value_and_grad(T.loss_and_metrics)``, the loss,
``router_aux`` and every gradient leaf, at the reduced configs.  This file
holds the recurrent mixers, the encoder and the frontends (the MoE configs
are in ``tests/test_torch_train_moe.py``, which imports the helpers here):

* ``xlstm_350m`` with ``xlstm_chunk`` 0 (the per-token mLSTM) and with a
  chunk of 16 at S = 64 (the chunkwise-parallel mLSTM), the sLSTM in both;
* ``hubert_xlarge`` (``enc`` layers, an audio batch of frontend embeddings
  and labels, no tokens: the token embedding's gradient is 0, as JAX's);
* ``qwen2_vl_72b`` (a vision batch: 8 frontend embeddings before 56
  tokens, labels of the tokens only, left-padded with -1; M-RoPE);
* ``qwen3_14b`` (q/k norms).

Inputs: B = 2 from a seeded numpy generator, the first 5 labels of one row
-1.  JAX's function is compiled once per case (a module fixture) with
XLA's ``allow_excess_precision`` off (``tests/test_torch_hybrid.py``
``_exact``), so every bfloat16 op rounds as its dtypes say.

Tolerances (PR 25's, ``tests/test_torch_train.py``), float32: the loss and
``router_aux`` within 1e-5 relative, each gradient leaf within 1e-4 of that
leaf's largest magnitude (measured: the loss within 2.2e-7, every leaf
within 1.5e-5, the xLSTM's forget-gate bias: summation order, and the
chunked form's other association of the recurrence).

Then remat on against off (bit-equal loss and gradients) for the chunked
xLSTM, a train step on the audio batch (the unread token embedding's
gradient is 0), and the train launcher on every one of the ten configs
(``--reduced --device cpu``, one step).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
from repro.models import mlp as JM
from repro.models import transformer as JT
from repro_torch import configs as C
from repro_torch.convert import params_from_jax
from repro_torch.models import mlp as PM
from repro_torch.models.transformer import Transformer
from test_torch_hybrid import MAX_SET_ASIDE, NEAR_TIE, _exact, _Routes

B = 2
# case: (arch, compute dtype, config overrides, batch kind, S)
CASES = {
    "xlstm-steps-float32": ("xlstm_350m", "float32", dict(xlstm_chunk=0),
                            "tokens", 64),
    "xlstm-chunked-float32": ("xlstm_350m", "float32", dict(xlstm_chunk=16),
                              "tokens", 64),
    "hubert-float32": ("hubert_xlarge", "float32", {}, "audio", 64),
    "qwen2_vl-float32": ("qwen2_vl_72b", "float32", {}, "vision", 64),
    "qwen3-float32": ("qwen3_14b", "float32", {}, "tokens", 128),
}
F32_TOL = dict(loss=1e-5, aux=1e-5, leaf=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small shapes: the suite runs several
    workers on the same cores, and torch's default of a thread a core
    oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _TrainRoutes(_Routes):
    """``tests/test_torch_hybrid.py``'s route recorder, with the port's top-k
    following JAX's route at a near tie out of place: the top-k indices and
    values are saved for the backward pass, so a flipped token's experts
    are replaced in a copy and its weights gathered anew from the
    probabilities (differentiable as the top-k is)."""

    def port_top_k(self, top_k):
        def following(probs, k):
            vals, idx = top_k(probs, k)
            jidx, jprobs = self.jax[self.calls]
            assert jidx.shape == tuple(idx.shape)
            want = torch.as_tensor(jidx, dtype=idx.dtype)
            flip = (torch.sort(idx).values != torch.sort(want).values).any(1)
            for t in torch.nonzero(flip)[:, 0].tolist():
                mine, theirs = set(idx[t].tolist()), set(jidx[t].tolist())
                gap = max(abs(float(jprobs[t, a] - jprobs[t, b]))
                          for a in theirs - mine for b in mine - theirs)
                (self.aside if gap <= NEAR_TIE else self.far).append(
                    (self.calls, t, gap))
            if flip.any():
                idx = torch.where(flip[:, None], want, idx)
                vals = torch.gather(probs, 1, idx)
            self.calls += 1
            self.routed += len(jidx)
            return vals, idx
        return following


def configs(arch, dtype, **kw):
    kw = dict(dict(compute_dtype=dtype, remat="none"), **kw)
    return (dataclasses.replace(JC.get_config(arch, reduced=True), **kw),
            dataclasses.replace(C.get_config(arch, reduced=True), **kw))


def make_batch(cfg, kind, s, seed=0):
    """tokens: (B, s) tokens and their next-token labels; audio: (B, s)
    frontend embeddings and s labels; vision: the config's frontend tokens
    then s - F tokens, labels for the tokens only."""
    rng = np.random.default_rng(seed)
    out = {}
    n_tok = s
    if kind != "tokens":
        f = s if kind == "audio" else cfg.n_frontend_tokens
        out["frontend_embeds"] = rng.standard_normal(
            (B, f, cfg.frontend_dim)).astype(np.float32)
        n_tok = s - f
    if kind == "audio":
        labels = rng.integers(0, cfg.vocab, (B, s)).astype(np.int32)
    else:
        toks = rng.integers(0, cfg.vocab, (B, n_tok + 1)).astype(np.int32)
        out["tokens"] = toks[:, :-1]
        labels = toks[:, 1:].copy()
    labels[0, :5] = -1
    out["labels"] = labels
    return out


def port_model(pc, jparams):
    m = Transformer(pc, device="cpu", param_dtype="float32")
    m.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams)))
    return m.requires_grad_(True)


def port_grads(m, batch):
    loss, metrics = m.loss_and_metrics(
        {k: torch.from_numpy(v) for k, v in batch.items()})
    params = dict(m.named_parameters())
    # an audio batch reads no token embedding: its gradient is 0, as JAX's
    grads = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True, materialize_grads=True)
    return loss.detach(), metrics, dict(zip(params, grads))


def jax_case(arch, dtype, kw, kind, s):
    """JAX's loss, metrics and gradients (as the port's state dict) of one
    case; in bfloat16 its routing too, recorded call by call."""
    jc, pc = configs(arch, dtype, **kw)
    params = JT.init_params(jc, jax.random.key(3))
    batch = make_batch(jc, kind, s)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    fn = jax.value_and_grad(lambda p, b: JT.loss_and_metrics(p, b, jc),
                            has_aux=True)
    routes = None
    with pytest.MonkeyPatch.context() as mp:
        if dtype == "bfloat16":
            routes = _TrainRoutes()
            mp.setattr(JM, "moe", routes.jax_moe(JM.moe))
        (loss, metrics), grads = _exact(fn, params, jb)(params, jb)
        jax.effects_barrier()
    return dict(jc=jc, pc=pc, params=params, batch=batch, routes=routes,
                loss=float(loss), metrics=jax.tree.map(np.asarray, metrics),
                grads=params_from_jax(jax.tree.map(
                    lambda a: np.asarray(a, np.float32), grads)))


def leaf_errors(got: dict, want: dict) -> dict:
    assert set(got) == set(want)
    return {k: float((got[k].float() - want[k]).abs().max()
                     / max(float(want[k].abs().max()), 1e-30))
            for k in want}


def check_case(c, case, kind, tol, monkeypatch):
    """The port's loss, router loss, label count and every gradient leaf
    against JAX's within ``tol`` (``loss`` and ``aux`` relative, ``leaf``
    of each leaf's largest magnitude).  In bfloat16 the port follows JAX's
    route at a near tie (``_TrainRoutes``); the count is printed."""
    routes = c["routes"]
    if routes is not None:
        routes.calls, routes.routed, routes.aside, routes.far = 0, 0, [], []
        monkeypatch.setattr(PM, "top_k", routes.port_top_k(PM.top_k))
    loss, metrics, grads = port_grads(port_model(c["pc"], c["params"]),
                                      c["batch"])
    if routes is not None:
        print(f"{case}: {len(routes.aside)} of {routes.routed} routed "
              f"tokens set aside at a near tie {routes.aside}")
        assert routes.calls == len(routes.jax)
        assert not routes.far, f"routes differ past a near tie: {routes.far}"
        assert len(routes.aside) <= MAX_SET_ASIDE
    assert abs(float(loss) - c["loss"]) <= tol["loss"] * abs(c["loss"])
    aux = float(metrics["router_aux"].detach())
    want_aux = float(c["metrics"]["router_aux"])
    assert abs(aux - want_aux) <= tol["aux"] * abs(want_aux)
    assert (aux > 0) == any(f == "moe" for _, f in c["pc"].layer_kinds)
    n_labels = c["batch"]["labels"].size - 5
    assert int(metrics["tokens"]) == int(c["metrics"]["tokens"]) == n_labels
    errs = leaf_errors(grads, c["grads"])
    worst = max(errs, key=errs.get)
    assert errs[worst] <= tol["leaf"], (worst, errs[worst])
    assert all(g.dtype == torch.float32 for g in grads.values())
    # every leaf the loss reads has a gradient somewhere
    unread = ["embed"] if kind == "audio" else []
    assert [k for k, g in grads.items() if float(g.abs().max()) == 0] == \
        unread


def check_remat(c, arch, dtype, kw):
    """remat="block" recomputes each layer in the backward pass: loss,
    router loss and gradients bit-equal to remat off."""
    off = port_grads(port_model(c["pc"], c["params"]), c["batch"])
    _, pc = configs(arch, dtype, **dict(kw, remat="block"))
    on = port_grads(port_model(pc, c["params"]), c["batch"])
    assert torch.equal(on[0], off[0])
    assert torch.equal(on[1]["router_aux"], off[1]["router_aux"])
    for k, g in off[2].items():
        assert torch.equal(on[2][k], g), k


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
    check_case(jax_cases(case), case, CASES[case][3], F32_TOL, monkeypatch)


def test_remat_gives_the_same_gradients(jax_cases):
    """The chunked xLSTM (mLSTM chunks and the sLSTM's per-token loop)
    with remat on and off: bit-equal."""
    case = "xlstm-chunked-float32"
    arch, dtype, kw, _, _ = CASES[case]
    check_remat(jax_cases(case), arch, dtype, kw)


def test_train_step_on_an_audio_batch(jax_cases):
    """``train_step`` on HuBERT's audio batch, which reads no token
    embedding: the embedding's gradient is 0, as JAX's (the step raised
    before ``materialize_grads``), so its m and v stay 0; the step's grad
    norm is that of JAX's gradients within 1e-5 relative."""
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import make_train_step
    c = jax_cases("hubert-float32")
    m = port_model(c["pc"], c["params"])
    state = adamw.init_state(dict(m.named_parameters()))
    step = make_train_step(c["pc"], adamw.AdamWConfig(
        lr=1e-3, warmup_steps=1, total_steps=10))
    _, state, metrics = step(m, state, {k: torch.from_numpy(v)
                                        for k, v in c["batch"].items()})
    assert not state["m"]["embed"].any() and not state["v"]["embed"].any()
    want = float(adamw.global_norm(c["grads"]))
    assert abs(float(metrics["grad_norm"]) - want) <= 1e-5 * want
    assert abs(float(metrics["loss"]) - c["loss"]) <= 1e-5 * abs(c["loss"])


@pytest.mark.parametrize("arch", C.ARCH_IDS)
def test_the_launcher_trains_every_config(arch, tmp_path):
    """``python -m repro_torch.launch.train --arch <arch> --reduced
    --device cpu``: one step on tokens from the pipeline, a finite loss
    and a grad norm above 0."""
    from repro_torch.launch.train import main
    hist = main(["--arch", arch.replace("_", "-"), "--reduced", "--device",
                 "cpu", "--steps", "1", "--seq-len", "64", "--batch", "1",
                 "--ckpt", str(tmp_path)])
    assert len(hist) == 1
    assert np.isfinite(hist[0]["loss"]) and hist[0]["grad_norm"] > 0

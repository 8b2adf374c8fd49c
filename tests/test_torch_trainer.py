"""The port's checkpoints, trainer, control plane and train launcher
(``repro_torch.train``, ``repro_torch.launch.train``) against the JAX
package's ``repro/train``.

* Checkpoints: every case of ``tests/train/test_checkpoint.py`` on torch
  trees, the host snapshot a copy (a CPU tensor updated in place after
  ``save`` does not reach the file), and the same on-disk layout both
  ways: a checkpoint the port writes restores through the JAX package's
  ``CheckpointManager`` and the other way round.
* The trainer: five steps of reduced ``qwen2_5_3b`` in float32 compute
  with ``remat="none"`` from the JAX ``Trainer``'s own parameters and the
  same pipeline seed, against that trainer: loss within 1e-5 relative,
  grad norm within 1e-4 relative and lr within 4 float32 ulps at every
  step (measured: 2.1e-7, 8.6e-7 and 0; XLA's fused multiply-adds in
  AdamW, see ``tests/test_torch_optim.py``, and summation order).  After
  them m and v within 2e-4 of each leaf's largest magnitude (measured
  5.3e-5), and every parameter within 2% of the sum of the five steps'
  learning rates (measured 0.9%: AdamW moves an element by up to about
  lr a step whatever its gradient's size, so where the gradient is
  rounding noise, as for the key bias, whose gradient is 0 in exact
  arithmetic since a softmax ignores a shift of its scores, the two
  packages' noise moves it apart by a share of lr).  Then
  ``tests/train/test_trainer.py``'s kill and resume: 10 steps with
  checkpoints at 5 and 10 (written asynchronously), a fresh trainer that
  resumes at 10 with the pipeline's step, 5 more steps, against 15
  uninterrupted steps within 2e-4 (measured: equal).
* ``HeartbeatMonitor``, ``StragglerPolicy``, ``plan_mesh``,
  ``rebatch_plan`` as in ``tests/train/test_ft_elastic.py`` and against
  the JAX package's on a grid; ``reshard`` onto a device.
* The launcher on the CPU, with a resume; and the trainer's default
  device is the card (it raises here).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
from repro.data.pipeline import RoaringDataPipeline as JPipe
from repro.optim.adamw import AdamWConfig as JAdamW
from repro.train import elastic as JE
from repro.train import ft as JFT
from repro.train.checkpoint import CheckpointManager as JManager
from repro.train.trainer import Trainer as JTrainer
from repro_torch import configs as C
from repro_torch.convert import opt_state_from_jax, params_from_jax
from repro_torch.data.pipeline import RoaringDataPipeline
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train import elastic as E
from repro_torch.train import ft as FT
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.trainer import Trainer


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small shapes: the suite runs several
    workers on the same cores, and torch's default of a thread a core
    oversubscribes them (30 small train steps took 121 s so, 1 s alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ----------------------------------------------------------- checkpoints
def tree(seed=0):
    r = np.random.default_rng(seed)
    return {"a": torch.from_numpy(r.standard_normal((8, 16)).astype(
                np.float32)),
            "nested": {"b": torch.from_numpy(r.integers(0, 9, (4,)).astype(
                           np.int32)),
                       "c": (torch.ones(3), torch.zeros(2, 2))}}


def _leaves(t):
    if isinstance(t, dict):
        return [x for k in sorted(t) for x in _leaves(t[k])]
    if isinstance(t, (list, tuple)):
        return [x for v in t for x in _leaves(v)]
    return [t]


def test_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    t = tree(1)
    mgr.save(7, t, extra={"foo": 1})
    got, extra = mgr.restore(7, t)
    assert extra == {"foo": 1}
    assert isinstance(got["nested"]["c"], tuple)
    for a, b in zip(_leaves(t), _leaves(got), strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_snapshot_is_a_copy(tmp_path):
    """The async save's host snapshot shares no memory with the tree: a
    CPU tensor changed right after ``save`` returns does not reach the
    file."""
    mgr = CheckpointManager(str(tmp_path))
    t = tree(2)
    want = t["a"].clone()
    mgr.save(1, t, async_=True)
    t["a"].add_(1.0)
    mgr.wait()
    got, _ = mgr.restore(1, t)
    assert torch.equal(got["a"], want)


def test_async_and_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in [1, 2, 3, 4]:
        mgr.save(s, tree(s), async_=True)
    mgr.wait()
    assert mgr.all_steps() == [3, 4]
    assert mgr.latest_step() == 4


def test_async_error_raised_at_wait(tmp_path):
    d = tmp_path / "ck"
    mgr = CheckpointManager(str(d))
    os.rmdir(d)
    d.write_text("a file where the directory was")
    mgr.save(1, tree(0), async_=True)         # the write thread fails
    with pytest.raises(OSError):
        mgr.wait()
    mgr.wait()                                # the error is raised once


def test_corrupt_fallback(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    t = tree(1)
    mgr.save(1, t)
    mgr.save(2, t)
    path = os.path.join(str(tmp_path), "step_0000000002", "arrays.npz")
    with open(path, "r+b") as f:
        f.seek(200)
        f.write(b"\xde\xad\xbe\xef" * 8)
    found = mgr.restore_with_retry(t)
    assert found is not None
    step, got, _ = found
    assert step == 1


def test_shape_mismatch_rejected(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, tree(1))
    bad = tree(1)
    bad["a"] = torch.zeros(9, 16)
    with pytest.raises(ValueError, match="shape mismatch"):
        mgr.restore(1, bad)
    missing = dict(tree(1), extra_leaf=torch.zeros(1))
    with pytest.raises(KeyError):
        mgr.restore(1, missing)


def test_no_tmp_dirs_after_save(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(5, tree(0))
    mgr.save(6, tree(0), async_=True)
    mgr.wait()
    assert not [d for d in os.listdir(tmp_path) if d.endswith(".tmp")]


def test_same_layout_as_the_jax_package(tmp_path):
    """A port checkpoint restores through the JAX package's manager, and a
    JAX checkpoint through the port's."""
    t = tree(3)
    jt = jax.tree.map(lambda x: jnp.asarray(x.numpy()), t)
    CheckpointManager(str(tmp_path / "p")).save(4, t, extra={"k": [1, 2]})
    got, extra = JManager(str(tmp_path / "p")).restore(4, jt)
    assert extra == {"k": [1, 2]}
    for a, b in zip(_leaves(t), jax.tree.leaves(got), strict=True):
        assert np.array_equal(a.numpy(), np.asarray(b))
    JManager(str(tmp_path / "j")).save(9, jt, extra={"s": "x"})
    got, extra = CheckpointManager(str(tmp_path / "j")).restore(9, t)
    assert extra == {"s": "x"}
    for a, b in zip(_leaves(t), _leaves(got), strict=True):
        assert torch.equal(a, b)


# --------------------------------------------------------------- trainer
def _cfgs():
    kw = dict(compute_dtype="float32", remat="none")
    return (dataclasses.replace(JC.get_config("qwen2_5_3b", reduced=True),
                                **kw),
            dataclasses.replace(C.get_config("qwen2_5_3b", reduced=True),
                                **kw))


OPT = dict(lr=3e-3, warmup_steps=5, total_steps=100, weight_decay=0.0)
PIPE = dict(n_docs=512, seq_len=32, batch_size=4, seed=7)


def make_trainer(tmp_path, tag="a", ckpt_every=5, cfg=None, **kw):
    cfg = cfg or C.get_config("qwen2_5_3b", reduced=True)
    cfg = dataclasses.replace(cfg, remat="none")
    pipe = RoaringDataPipeline(vocab=cfg.vocab, device="cpu", **PIPE)
    return Trainer(cfg, AdamWConfig(**OPT), pipe, str(tmp_path / tag),
                   ckpt_every=ckpt_every, device="cpu", **kw)


def test_five_steps_against_the_jax_trainer(tmp_path):
    jc, pc = _cfgs()
    jt = JTrainer(jc, JAdamW(**OPT), JPipe(vocab=jc.vocab, **PIPE),
                  str(tmp_path / "jax"), ckpt_every=100, async_ckpt=False)
    pt = make_trainer(tmp_path, "port", ckpt_every=100, cfg=pc,
                      async_ckpt=False)
    pt.model.load_state_dict(params_from_jax(
        jax.tree.map(np.asarray, jt.params)))
    want_hist = jt.train(5, log_every=100)
    got = pt.train(5, log_every=100)
    for g, w in zip(got, want_hist, strict=True):
        assert g["step"] == w["step"]
        assert abs(g["loss"] - w["loss"]) <= 1e-5 * abs(w["loss"])
        assert abs(g["grad_norm"] - w["grad_norm"]) <= 1e-4 * w["grad_norm"]
        assert abs(g["lr"] - w["lr"]) <= 4 * np.spacing(np.float32(w["lr"]))
    assert pt.pipeline.step == jt.pipeline.step == 5
    # the parameters and AdamW's state after the five steps, leaf by leaf
    want = opt_state_from_jax(jax.tree.map(np.asarray, jt.opt_state))
    want["params"] = params_from_jax(jax.tree.map(np.asarray, jt.params))
    assert int(pt.opt_state["step"]) == int(want["step"]) == 5
    moved = sum(w["lr"] for w in want_hist)
    for key, got in (("params", pt.params), ("m", pt.opt_state["m"]),
                     ("v", pt.opt_state["v"])):
        assert set(got) == set(want[key])
        for k, w in want[key].items():
            err = float((got[k].detach() - w).abs().max())
            limit = 0.02 * moved if key == "params" else \
                2e-4 * float(w.abs().max())
            assert err <= limit, (key, k, err)
    assert np.array_equal(pt.pipeline.seen.to_array(),
                          jt.pipeline.seen.to_array())


def test_kill_and_resume(tmp_path):
    tr1 = make_trainer(tmp_path, "run", async_ckpt=True)
    tr1.train(10, log_every=100)
    assert tr1.ckpt.all_steps() == [5, 10]
    tr2 = make_trainer(tmp_path, "run")
    assert tr2.maybe_resume()
    assert tr2.step == 10
    assert int(tr2.opt_state["step"]) == 10
    assert tr2.pipeline.step == tr1.pipeline.step == 10
    h2 = tr2.train(5, log_every=100)
    tr3 = make_trainer(tmp_path, "ref")
    h3 = tr3.train(15, log_every=100)
    np.testing.assert_allclose([h["loss"] for h in h2],
                               [h["loss"] for h in h3[-5:]],
                               rtol=2e-4, atol=2e-4)
    assert np.array_equal(tr2.pipeline.seen.to_array(),
                          tr3.pipeline.seen.to_array())
    assert not make_trainer(tmp_path, "empty").maybe_resume()


def test_non_finite_loss_raises(tmp_path):
    tr = make_trainer(tmp_path)
    with torch.no_grad():
        tr.params["final_norm.scale"].fill_(float("nan"))
    with pytest.raises(FloatingPointError):
        tr.train(1)


def test_trainer_runs_on_the_card_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a GPU")
    cfg = C.get_config("qwen2_5_3b", reduced=True)
    pipe = RoaringDataPipeline(vocab=cfg.vocab, device="cpu", **PIPE)
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(cfg, AdamWConfig(), pipe, str(tmp_path))


def test_launcher_on_the_cpu(tmp_path, capsys):
    from repro_torch.launch.train import main
    args = ["--arch", "qwen2.5-3b", "--reduced", "--device", "cpu",
            "--steps", "2", "--seq-len", "16", "--batch", "2",
            "--ckpt", str(tmp_path), "--ckpt-every", "2"]
    main(args)
    assert CheckpointManager(str(tmp_path)).all_steps() == [2]
    main(args + ["--resume"])
    assert "resumed at step 2" in capsys.readouterr().out
    assert CheckpointManager(str(tmp_path)).all_steps() == [2, 4]


# ---------------------------------------------------- ft and elastic
def test_heartbeat_and_stragglers():
    for mod in (FT, JFT):
        hb = mod.HeartbeatMonitor(timeout_s=10)
        hb.beat("h0", 0.0)
        hb.beat("h1", 0.0)
        hb.beat("h0", 8.0)
        assert hb.failed_hosts(now=12.0) == ["h1"]
        assert hb.alive_hosts(now=12.0) == ["h0"]
    sp, jsp = FT.StragglerPolicy(1.5, 2), JFT.StragglerPolicy(1.5, 2)
    rng = np.random.default_rng(5)
    for _ in range(12):
        for h in ["h0", "h1", "h2", "h3"]:
            d = float(rng.uniform(0.5, 4.0))
            sp.observe(h, d)
            jsp.observe(h, d)
        assert sp.stragglers() == jsp.stragglers()
    assert FT.StragglerPolicy.scale_for_skipped(16, 2) == \
        JFT.StragglerPolicy.scale_for_skipped(16, 2)


def test_plan_mesh_and_rebatch_against_jax():
    for chips in (16, 17, 253, 256, 511, 512, 1000, 4096):
        for mp in (1, 8, 16):
            assert dataclasses.astuple(E.plan_mesh(chips, mp, 256)) == \
                dataclasses.astuple(JE.plan_mesh(chips, mp, 256))
    with pytest.raises(ValueError):
        E.plan_mesh(8, 16)
    for gb, old, new in ((256, 16, 15), (256, 16, 8), (256, 16, 16),
                         (100, 3, 7), (7, 1, 2), (1, 4, 1)):
        assert E.rebatch_plan(gb, old, new) == JE.rebatch_plan(gb, old, new)


def test_reshard_onto_a_device():
    t = {"w": np.arange(32.0).reshape(8, 4), "s": [torch.ones(2)],
         "n": {"i": np.int32(3)}}
    placed = E.reshard(t, torch.device("cpu"))
    assert np.array_equal(placed["w"].numpy(), t["w"])
    assert placed["s"][0].device.type == "cpu"
    assert int(placed["n"]["i"]) == 3

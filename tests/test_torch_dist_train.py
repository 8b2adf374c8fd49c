"""The sharded train step on the CPU: DTensor parameters, AdamW state and
batch placed by the sharding rules (``train_step.shard_train_state``),
held against the plain step on the same weights and batch.

* On a ``gloo`` group of one (an in-process ``HashStore``) with the local
  (1, 1) mesh every shard is the whole tensor: the step is bit-equal to
  the plain one, for Qwen2.5-3B and Mixtral-8x7B (reduced).
* One test spawns a ``gloo`` world of 4 on a (2, 2) mesh, where the
  shards and the collectives are real: the loss, gradient norm and
  parameters agree with the plain step within float32 rounding of the
  reordered sums.  It has a time limit of its own (``_WORLD4_LIMIT_S``).
* ``launch.train --distributed`` joins a group of one from torchrun's
  environment and trains.

Every test destroys the group it made, since the suite's workers run
other files after this one.
"""

import dataclasses
import multiprocessing as mp
import os
import socket
import time

import pytest
import torch
import torch.distributed as dist

from repro_torch import configs as C
from repro_torch.dist import ctx
from repro_torch.launch import mesh as M
from repro_torch.models.transformer import Transformer
from repro_torch.optim import adamw
from repro_torch.train import train_step as TS

_WORLD4_LIMIT_S = 60


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def gloo_one():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    yield M.make_local_mesh(device_type="cpu")
    dist.destroy_process_group()


def _cfg(arch, **kw):
    return dataclasses.replace(C.get_config(arch, reduced=True), **kw)


def _model(cfg):
    g = torch.Generator("cpu").manual_seed(0)
    m = Transformer(cfg, device="cpu", generator=g,
                    param_dtype=cfg.param_dtype)
    m.requires_grad_(True)
    return m


def _batch(cfg, b, s):
    toks = torch.randint(0, cfg.vocab, (b, s), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(1))
    return {"tokens": toks, "labels": toks}


def _steps(cfg, batch, mesh, n=2):
    """(plain model, plain metrics, sharded model, sharded metrics) after
    ``n`` steps from the same start."""
    step = TS.make_train_step(cfg, adamw.AdamWConfig(warmup_steps=1))
    m0 = _model(cfg)
    o0 = adamw.init_state(dict(m0.named_parameters()))
    m1 = _model(cfg)
    o1, b1 = TS.shard_train_state(
        m1, adamw.init_state(dict(m1.named_parameters())), dict(batch),
        mesh)
    r0s, r1s = [], []
    for _ in range(n):
        _, o0, r0 = step(m0, o0, dict(batch))
        _, o1, r1 = step(m1, o1, b1)
        r0s.append(r0)
        r1s.append({k: v.full_tensor() if ctx.is_dtensor(v) else v
                    for k, v in r1.items()})
    return m0, r0s, m1, r1s, o1


@pytest.mark.parametrize("arch", ["qwen2_5_3b", "mixtral_8x7b"])
def test_sharded_step_on_a_group_of_one_is_bit_equal(gloo_one, arch):
    cfg = _cfg(arch)
    m0, r0s, m1, r1s, o1 = _steps(cfg, _batch(cfg, 2, 32), gloo_one)
    for r0, r1 in zip(r0s, r1s):
        for k in r0:
            assert torch.equal(r0[k], r1[k]), k
    params = dict(m1.named_parameters())
    for name, p in m0.named_parameters():
        assert ctx.is_dtensor(params[name])
        assert torch.equal(p, params[name].full_tensor()), name
    assert ctx.is_dtensor(o1["m"]["embed"]) and not ctx.is_dtensor(
        o1["step"])
    assert int(o1["step"]) == 2


def _world4(rank, port, arch, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=4)
    try:
        mesh = M.make_local_mesh(2, device_type="cpu")
        cfg = _cfg(arch, compute_dtype="float32", n_layers=2)
        m0, r0s, m1, r1s, _ = _steps(cfg, _batch(cfg, 4, 32), mesh, n=1)
        sharded = {k: p.detach().full_tensor()
                   for k, p in m1.named_parameters()}
        diff = max(float((p.detach() - sharded[k]).abs().max())
                   for k, p in m0.named_parameters())
        if rank == 0:
            out.put((tuple(mesh.shape),
                     {k: (float(r0s[0][k]), float(r1s[0][k]))
                      for k in ("loss", "grad_norm")}, diff))
    finally:
        dist.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_sharded_step_on_a_world_of_four():
    """A (2, 2) mesh of 4 gloo processes: real shards and collectives."""
    spawn = mp.get_context("spawn")
    out = spawn.Queue()
    port = _free_port()
    t0 = time.monotonic()
    procs = [spawn.Process(target=_world4, args=(r, port, "qwen2_5_3b",
                                                 out)) for r in range(4)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(max(1.0, _WORLD4_LIMIT_S - (time.monotonic() - t0)))
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
    assert not alive, f"the world of 4 ran past {_WORLD4_LIMIT_S} s"
    assert [p.exitcode for p in procs] == [0] * 4
    shape, metrics, diff = out.get(timeout=5)
    assert shape == (2, 2)
    for plain, sharded in metrics.values():
        assert abs(plain - sharded) <= 1e-5 * abs(plain)
    # AdamW moves each weight by about lr (3e-4) whatever its gradient's
    # size; where a gradient is near eps (1e-8) the reordered sums move it
    # differently, so the weights agree to a tenth of one step
    assert diff <= 0.1 * adamw.AdamWConfig().lr


def test_train_launcher_distributed(tmp_path, monkeypatch):
    from repro_torch.launch import train
    for k, v in {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
                 "MASTER_ADDR": "127.0.0.1",
                 "MASTER_PORT": str(_free_port())}.items():
        monkeypatch.setenv(k, v)
    hist = train.main(["--arch", "qwen2.5-3b", "--reduced", "--device",
                       "cpu", "--distributed", "--steps", "2",
                       "--seq-len", "32", "--batch", "2", "--ckpt",
                       str(tmp_path / "ck")])
    assert not dist.is_initialized()
    assert len(hist) == 2
    assert all(torch.isfinite(torch.tensor(h["loss"])) for h in hist)
    assert os.environ["WORLD_SIZE"] == "1"


@pytest.mark.parametrize("arch", ["gemma2_27b", "xlstm_350m"])
def test_sharded_prefill_on_a_group_of_one_is_bit_equal(gloo_one, arch):
    """A prefill on DTensor parameters and tokens: the decode state is
    placed shard by shard (``Transformer.placed_decode_state``, constant
    fills such as the mLSTM's -1e30 included); logits and every state leaf
    equal the plain prefill's."""
    from repro_torch.dist import sharding as SH
    cfg = C.get_config(arch, reduced=True)
    models = []
    for _ in range(2):
        models.append(Transformer(cfg, device="cpu",
                                  generator=torch.Generator().manual_seed(0)))
    toks = _batch(cfg, 2, 32)["tokens"]
    want, wstate = models[0].prefill(toks, s_max=64)
    SH.shard_module(models[1], gloo_one)
    with ctx.on_mesh(gloo_one):
        dt = SH.distribute({"t": toks}, SH.batch_shardings(
            {"t": toks}, gloo_one))["t"]
        got, gstate = models[1].prefill(dt, s_max=64)
    assert torch.equal(got.full_tensor(), want)
    flat = dict(SH.leaves_with_path(gstate))
    for path, w in SH.leaves_with_path(wstate):
        assert ctx.is_dtensor(flat[path]), path
        assert torch.equal(flat[path].full_tensor(), w), path

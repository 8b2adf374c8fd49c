"""The training step: loss -> gradients -> clip -> AdamW update, the port
of the JAX package's ``repro/train/train_step.py``.

    train_step(model, opt_state, batch) -> (model, opt_state, metrics)

``model`` is a ``models.transformer.Transformer`` holding float32 masters
with gradients on; its parameters are updated in place.  The metric keys
are JAX's: ``loss``, ``ce_loss``, ``router_aux``, ``grad_norm``, ``lr``
(0-dim float32 tensors); the eval step's ``loss`` and ``tokens``.

Two profiler ranges split a step: ``train_step.forward_backward`` and
``train_step.optimizer`` (``torch.profiler.record_function``; without a
profiler each costs a few microseconds of host time).

The sharded step.  :func:`shard_train_state` places a model's parameters,
AdamW's state and a batch on a ``DeviceMesh`` as the JAX dry run places
them: parameters and both moments by ``dist.sharding.param_shardings``,
the batch by ``batch_shardings``, the step counter on the host (JAX
replicates it).  The same ``train_step`` then runs on DTensors: under
the mesh (``dist.ctx.activate``, which the model's sharding notes read)
and with plain tensors -- positions, masks, a fresh accumulator --
taken as replicated (``implicit_replication``), as GSPMD takes a
constant.
"""

from __future__ import annotations

import contextlib

import torch
from torch.profiler import record_function

from repro_torch.dist import ctx
from repro_torch.optim import adamw


def shard_train_state(model, opt_state, batch, mesh, *,
                      pure_dp: bool = False):
    """Place ``model``'s parameters (swapped in place for DTensor
    parameters of the same name, ``requires_grad`` kept), ``opt_state``'s
    m and v and ``batch`` on ``mesh`` by the sharding rules; returns
    (opt_state, batch) placed.  Whole tensors go in, on the mesh's device
    type (or meta)."""
    from repro_torch.dist import sharding as SH
    SH.shard_module(model, mesh, pure_dp=pure_dp)
    opt = {"m": SH.distribute(opt_state["m"], SH.param_shardings(
               opt_state["m"], mesh, pure_dp=pure_dp)),
           "v": SH.distribute(opt_state["v"], SH.param_shardings(
               opt_state["v"], mesh, pure_dp=pure_dp)),
           "step": opt_state["step"]}
    batch = SH.distribute(batch, SH.batch_shardings(batch, mesh,
                                                    pure_dp=pure_dp))
    return opt, batch


def _on_mesh(params):
    """The mesh context of a step on DTensor parameters
    (``dist.ctx.on_mesh``), else nothing."""
    p = next(iter(params.values()), None)
    if not ctx.is_dtensor(p):
        return contextlib.nullcontext()
    return ctx.on_mesh(p.device_mesh)


def make_train_step(cfg, opt_cfg: adamw.AdamWConfig):
    def train_step(model, opt_state, batch):
        params = dict(model.named_parameters())
        with _on_mesh(params), record_function(
                "train_step.forward_backward"):
            loss, metrics = model.loss_and_metrics(batch)
            # a leaf the batch does not read (the token embedding under a
            # batch of frontend embeddings alone) gets a gradient of 0, as
            # JAX gives it
            grads = dict(zip(params, torch.autograd.grad(
                loss, list(params.values()), allow_unused=True,
                materialize_grads=True)))
        with _on_mesh(params), record_function("train_step.optimizer"):
            _, opt_state, opt_metrics = adamw.apply_updates(
                params, grads, opt_state, opt_cfg)
        del grads
        out = {"loss": loss.detach().float(),
               "ce_loss": metrics["ce_loss"].detach().float(),
               "router_aux": metrics["router_aux"].detach().float(),
               "grad_norm": opt_metrics["grad_norm"],
               "lr": opt_metrics["lr"]}
        return model, opt_state, out

    return train_step


def make_eval_step(cfg):
    @torch.no_grad()
    def eval_step(model, batch):
        loss, metrics = model.loss_and_metrics(batch)
        return {"loss": loss.float(), "tokens": metrics["tokens"]}
    return eval_step

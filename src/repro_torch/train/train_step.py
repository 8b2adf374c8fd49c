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
"""

from __future__ import annotations

import torch
from torch.profiler import record_function

from repro_torch.optim import adamw


def make_train_step(cfg, opt_cfg: adamw.AdamWConfig):
    def train_step(model, opt_state, batch):
        params = dict(model.named_parameters())
        with record_function("train_step.forward_backward"):
            loss, metrics = model.loss_and_metrics(batch)
            # a leaf the batch does not read (the token embedding under a
            # batch of frontend embeddings alone) gets a gradient of 0, as
            # JAX gives it
            grads = dict(zip(params, torch.autograd.grad(
                loss, list(params.values()), allow_unused=True,
                materialize_grads=True)))
        with record_function("train_step.optimizer"):
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

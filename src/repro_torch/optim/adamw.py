"""AdamW with float32 master weights, global-norm clipping and the LR
schedule: the JAX package's ``repro/optim/adamw.py`` op for op.

A parameter tree here is a dict of dotted names to tensors (a state dict);
the optimizer state mirrors it: ``{"m": {...}, "v": {...}, "step"}``, m
and v float32 on each parameter's device, ``step`` a 0-dim int32 tensor on
the host.  The schedule and the bias corrections are float32 operations
on the host (``lr_at``, ``b ** step``), then 0-dim tensors on the
parameters' device, so the card and the CPU compute the same update:
a CUDA division by a host scalar would multiply by its reciprocal.

Not ``torch.optim.AdamW``, which adds ``eps`` after dividing ``sqrt(v)`` by
``sqrt(bc2)`` and decays as ``p * (1 - lr * wd)``; this computes ``m_hat /
(sqrt(v_hat) + eps)`` and ``p - lr * (delta + wd * p)``, decaying every
leaf (norms and biases too), as JAX does.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def lr_at(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warm-up, then cosine decay: a 0-dim float32 host tensor."""
    step = torch.as_tensor(step).to(torch.float32).cpu()
    warm = torch.minimum(step / _f32(max(cfg.warmup_steps, 1)), _f32(1.0))
    prog = torch.clamp((step - _f32(cfg.warmup_steps))
                       / _f32(max(cfg.total_steps - cfg.warmup_steps, 1)),
                       0.0, 1.0)
    cos = _f32(0.5) * (_f32(1.0) + torch.cos(_f32(np.pi) * prog))
    scale = _f32(cfg.min_lr_ratio) + _f32(1 - cfg.min_lr_ratio) * cos
    return _f32(cfg.lr) * warm * scale


def init_state(params: dict) -> dict:
    return {"m": {k: torch.zeros_like(p, dtype=torch.float32)
                  for k, p in params.items()},
            "v": {k: torch.zeros_like(p, dtype=torch.float32)
                  for k, p in params.items()},
            "step": torch.zeros((), dtype=torch.int32)}


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum of every leaf's float32 sum of squares, the leaves
    in sorted-key order (``jax.tree.leaves`` of the same dict)."""
    return torch.sqrt(sum(torch.sum(torch.square(tree[k].float()))
                          for k in sorted(tree)))


def _clip_scale(gn: torch.Tensor, max_norm: float) -> torch.Tensor:
    # a true division: ``max_norm / gn`` would be gn's reciprocal times it
    return torch.clamp(torch.full_like(gn, max_norm)
                       / torch.clamp(gn, min=1e-9), max=1.0)


def clip_by_global_norm(grads: dict, max_norm: float):
    """-> (float32 copies of the gradients times min(1, max_norm / norm),
    the norm); the scale multiplies every gradient, also when it is 1."""
    gn = global_norm(grads)
    scale = _clip_scale(gn, max_norm)
    return {k: g.float() * scale for k, g in grads.items()}, gn


@torch.no_grad()
def apply_updates(params: dict, grads: dict, state: dict, cfg: AdamWConfig):
    """One AdamW step, IN PLACE: ``params`` and the state's m and v are
    updated, the state's ``step`` replaced; returns (params, state,
    {"grad_norm", "lr"}).  The clip runs leaf by leaf inside the update,
    so no second float32 copy of the gradients is kept."""
    gn = global_norm(grads)
    step = state["step"] + 1
    lr = lr_at(cfg, step)
    stepf = step.to(torch.float32)
    bc1 = _f32(1.0) - torch.pow(_f32(cfg.b1), stepf)
    bc2 = _f32(1.0) - torch.pow(_f32(cfg.b2), stepf)
    on = {}                 # the 0-dim scalars, once on each device

    def scalars(dev):
        if dev not in on:
            on[dev] = (_clip_scale(gn, cfg.grad_clip).to(dev),
                       *(t.to(dev) for t in (lr, bc1, bc2)))
        return on[dev]

    b1, b2 = cfg.b1, cfg.b2
    for k, p in params.items():
        scale, lr_d, bc1_d, bc2_d = scalars(p.device)
        m, v = state["m"][k], state["v"][k]
        g = grads[k].float() * scale
        m.mul_(b1).add_(g * (1 - b1))           # b1 * m + (1 - b1) * g
        g2 = g * (1 - b2)
        v.mul_(b2).add_(g2.mul_(g))             # b2 * v + (1 - b2) * g * g
        del g, g2
        v_hat = (v / bc2_d).sqrt_().add_(cfg.eps)
        delta = (m / bc1_d).div_(v_hat)         # m_hat / (sqrt(v_hat) + eps)
        del v_hat
        p32 = p.float()
        delta.add_(p32 * cfg.weight_decay).mul_(lr_d)
        if p.dtype == torch.float32:
            p.sub_(delta)                       # p - lr * (delta + wd * p)
        else:
            p.copy_(p32 - delta)
    new_state = {"m": state["m"], "v": state["v"], "step": step}
    return params, new_state, {"grad_norm": gn, "lr": lr}

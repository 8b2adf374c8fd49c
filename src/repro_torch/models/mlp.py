"""Dense feed-forward layer, the port of ``mlp`` in the JAX package's
``repro/models/mlp.py``.  Mixture of Experts is not ported yet (ROADMAP
Queue 1).

``p`` is a ``models.transformer.MLP``: ``w_gate``, ``w_up`` and ``w_down``
for the gated activations (swiglu, geglu), ``w_in`` and ``w_out`` for gelu,
stored in the compute dtype.
"""

from __future__ import annotations

import numpy as np
import torch


def _const(value, like):
    """A 0-dim constant rounded to ``like``'s dtype, as JAX rounds a weakly
    typed Python float to the array's dtype."""
    return torch.tensor(value, dtype=like.dtype)


def gelu_tanh(x):
    """``jax.nn.gelu`` (its default tanh approximation) op for op in x's
    dtype, with its constants in that dtype.  In bfloat16 the fused
    ``F.gelu(x, approximate="tanh")`` rounds once where JAX rounds after
    every op, and uses sqrt(2/pi) where JAX uses its bfloat16 value
    0.796875: it differs from JAX in about 43% of elements."""
    inner = x + _const(0.044715, x) * x.pow(3)
    cdf = _const(0.5, x) * (_const(1.0, x) + torch.tanh(
        _const(np.sqrt(2 / np.pi), x) * inner))
    return x * cdf


def _act(x, kind):
    if kind == "swiglu":
        return x * torch.sigmoid(x)          # jax.nn.silu
    return gelu_tanh(x)


def mlp(x, p, cfg):
    if cfg.act in ("swiglu", "geglu"):
        h = _act(x @ p.w_gate, cfg.act)
        h.mul_(x @ p.w_up)            # in place: no third (tokens, ff) buffer
        return h @ p.w_down
    return _act(x @ p.w_in, "gelu") @ p.w_out

"""Carry Roaring state across packages as plain numpy parts.

A bitmap's parts are its chunk keys, its container kinds ("array",
"bitset" or "run") and each container's payload: the sorted uint16
``values`` of an array, the (1024,) uint64 ``words`` of a bitset, or the
(R, 2) int32 ``[start, length]`` ``runs`` of a run container.
:func:`bitmap_to_parts` reads them off any object with ``keys`` and
``containers`` of those kinds, so a JAX-package bitmap converts without this
module importing that package.

An index's parts are its postings alone: the similarity engine, the arena
and the query server are derived from the postings at run time, so two
indexes built from the same parts answer every query alike.

A ``RoaringTensor``'s parts are its five component arrays: ``keys``,
``kinds``, ``cards`` and ``aux`` as int32 and ``slab`` as uint16.
:func:`tensor_to_parts` reads them off any object with those attributes
(torch tensors, or arrays numpy can read), so a JAX-package tensor
converts the same way.

A model's parameters come from the JAX package's pytree, read as numpy
arrays: :func:`params_from_jax` unstacks the scanned pattern groups into the
port's per-layer state dict (``models.transformer``), so both packages
compute with the same weights; :func:`opt_state_from_jax` maps AdamW's
state the same way.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.bitmap import RoaringBitmap
from repro_torch.core.containers import (
    ArrayContainer, BitsetContainer, RunContainer,
)
from repro_torch.core.tensor import RoaringTensor
from repro_torch.data.index import InvertedIndex
from repro_torch.kernels.ops import resolve_device

_PAYLOAD = {"array": "values", "bitset": "words", "run": "runs"}


def bitmap_to_parts(bm) -> tuple[list[int], list[str], list[np.ndarray]]:
    """(keys, kinds, payloads) of a bitmap; payloads are copies."""
    kinds = [c.kind for c in bm.containers]
    payloads = [np.array(getattr(c, _PAYLOAD[k]))
                for c, k in zip(bm.containers, kinds)]
    return [int(k) for k in bm.keys], kinds, payloads


def bitmap_from_parts(keys, kinds, payloads) -> RoaringBitmap:
    """The port's RoaringBitmap with exactly these containers."""
    conts = []
    for kind, p in zip(kinds, payloads, strict=True):
        if kind == "array":
            conts.append(ArrayContainer(np.array(p, np.uint16)))
        elif kind == "bitset":
            conts.append(BitsetContainer(np.array(p, np.uint64)))
        elif kind == "run":
            conts.append(RunContainer(np.array(p, np.int32).reshape(-1, 2)))
        else:
            raise ValueError(f"unknown container kind {kind!r}")
    keys = [int(k) for k in keys]
    if len(keys) != len(conts) or keys != sorted(set(keys)):
        raise ValueError("keys must be strictly increasing, one per "
                         "container")
    return RoaringBitmap(keys, conts)


def index_from_parts(postings_parts, n_docs: int, *, arena=None,
                     device=None) -> InvertedIndex:
    """An InvertedIndex over ``{term: (keys, kinds, payloads)}``."""
    return InvertedIndex.from_postings(
        {t: bitmap_from_parts(*parts) for t, parts in postings_parts.items()},
        n_docs, arena=arena, device=device)


def _host(x) -> np.ndarray:
    return np.asarray(x.cpu().numpy() if isinstance(x, torch.Tensor) else x)


def tensor_to_parts(t) -> tuple[np.ndarray, ...]:
    """(keys, kinds, cards, aux, slab) of a RoaringTensor as numpy copies:
    the first four int32, ``slab`` uint16 (an int16 slab is read as its
    bits)."""
    keys, kinds, cards, aux = (np.array(_host(getattr(t, n)), np.int32)
                               for n in ("keys", "kinds", "cards", "aux"))
    slab = np.ascontiguousarray(_host(t.slab))
    slab = slab.view(np.uint16).copy() if slab.dtype == np.int16 else \
        np.array(slab, np.uint16)
    return keys, kinds, cards, aux, slab


def tensor_from_parts(keys, kinds, cards, aux, slab, *,
                      device=None) -> RoaringTensor:
    """The port's RoaringTensor with exactly these components, on
    ``device`` (the card unless the caller names another)."""
    dev = resolve_device(device)
    ints = (torch.from_numpy(np.array(x, np.int32)).to(dev)
            for x in (keys, kinds, cards, aux))
    slab = torch.from_numpy(np.array(slab, np.uint16).view(np.int16)).to(dev)
    return RoaringTensor(*ints, slab)


def _flatten(prefix: str, tree, out: dict) -> None:
    for name, x in tree.items():
        key = f"{prefix}.{name}" if prefix else name
        if isinstance(x, dict):
            _flatten(key, x, out)
        else:
            out[key] = torch.from_numpy(np.array(x, np.float32))


def params_from_jax(tree) -> dict[str, torch.Tensor]:
    """The port's ``Transformer`` state dict (float32 CPU tensors; loading
    casts them to the model's dtypes) from a JAX parameter tree of numpy
    arrays.  ``prefix_<i>`` is layer ``i``; pattern position ``pi`` of
    repeat ``r`` (the leading axis of ``tree["pattern"][pi]``) is layer
    ``n_prefix + r * len(pattern) + pi``.  Nested dicts become dotted keys,
    so every mixer (attention ``mixer.wq``, MLA ``mixer.w_dkv``, Mamba
    ``mixer.A_log``, mLSTM ``mixer.wi``, sLSTM ``mixer.r``, ...), MLP and
    MoE blocks (``ffn.router``, ``ffn.wg``, ``ffn.shared.w_gate``, ...) map
    alike; ``frontend_proj`` keeps its name."""
    out: dict[str, torch.Tensor] = {}
    _flatten("", {k: tree[k] for k in ("embed", "lm_head", "final_norm",
                                       "frontend_proj") if k in tree}, out)
    n_prefix = sum(k.startswith("prefix_") for k in tree)
    for i in range(n_prefix):
        _flatten(f"layers.{i}", tree[f"prefix_{i}"], out)
    pattern = tree.get("pattern", ())
    for pi, group in enumerate(pattern):
        stacked: dict = {}
        _flatten("", group, stacked)
        for key, x in stacked.items():
            for r in range(x.shape[0]):
                out[f"layers.{n_prefix + r * len(pattern) + pi}.{key}"] = \
                    x[r].clone()
    return out


def opt_state_from_jax(state) -> dict:
    """The port's AdamW state (``optim.adamw``) from the JAX package's
    ``{"m", "v", "step"}`` of numpy arrays: ``m`` and ``v`` mirror the
    parameter tree, so they map as :func:`params_from_jax` maps it."""
    return {"m": params_from_jax(state["m"]), "v": params_from_jax(state["v"]),
            "step": torch.tensor(int(np.asarray(state["step"])),
                                 dtype=torch.int32)}

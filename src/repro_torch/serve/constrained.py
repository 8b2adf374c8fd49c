"""Constrained decoding with Roaring vocabulary masks, the port of the JAX
package's ``repro/serve/constrained.py``.

An allowed-token set over a 152 k vocabulary is 3 Roaring chunks; grammar /
lexicon state transitions are set algebra (union of continuations,
intersection with hard filters, difference for banned strings) -- all on the
paper's operations, including the count-only variants for quick feasibility
checks.  At sampling time the active set renders to a dense additive mask.
The set algebra runs on ``device`` (the card unless the caller names
another).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import RoaringBitmap, pairwise, to_dense
from repro_torch.kernels.ops import resolve_device


class VocabConstraint:
    def __init__(self, vocab: int, allowed: RoaringBitmap | None = None, *,
                 device=None):
        self.vocab = vocab
        self.device = resolve_device(device)
        self.allowed = allowed if allowed is not None \
            else RoaringBitmap.from_range(0, vocab)

    # set algebra over constraints -----------------------------------
    def _merge(self, other: RoaringBitmap, op: str) -> "VocabConstraint":
        return VocabConstraint(
            self.vocab, pairwise.merge_one(self.allowed, other, op,
                                           device=self.device),
            device=self.device)

    def intersect(self, other: "VocabConstraint") -> "VocabConstraint":
        return self._merge(other.allowed, "and")

    def union(self, other: "VocabConstraint") -> "VocabConstraint":
        return self._merge(other.allowed, "or")

    def ban(self, token_ids) -> "VocabConstraint":
        return self._merge(RoaringBitmap.from_values(
            np.asarray(token_ids, np.uint32)), "andnot")

    def feasible(self) -> bool:
        return self.allowed.cardinality > 0   # fast count, never materialize

    def n_allowed(self) -> int:
        return self.allowed.cardinality

    # rendering --------------------------------------------------------
    def dense_mask(self) -> np.ndarray:
        """(V,) float32 additive mask: 0 for allowed, -inf for banned."""
        dense = to_dense(self.allowed, self.vocab)
        return np.where(dense, 0.0, -np.inf).astype(np.float32)

    def apply(self, logits: torch.Tensor) -> torch.Tensor:
        """logits + the float32 mask (bfloat16 logits promote to float32,
        as in the JAX package)."""
        return logits + torch.from_numpy(self.dense_mask()).to(logits.device)


def lexicon_constraint(vocab: int, lexicons: dict[str, np.ndarray],
                       active: list[str], *, device=None) -> VocabConstraint:
    """Union of the active lexicons' token sets."""
    bms = [RoaringBitmap.from_values(lexicons[name].astype(np.uint32))
           for name in active]
    if not bms:
        return VocabConstraint(vocab, device=device)
    return VocabConstraint(vocab, RoaringBitmap.or_many(bms, device=device),
                           device=device)

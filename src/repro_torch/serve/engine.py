"""Batched serving engine: prefill -> decode loop with Roaring integrations,
the port of the JAX package's ``repro/serve/engine.py``.

Per-request state carries
  * a Roaring block-visibility set (sink + sliding local + pinned blocks)
    rendered to container words for the block-sparse attention kernel,
  * an optional VocabConstraint (constrained decoding),
  * paged-KV bookkeeping via PagedKVAllocator.
It runs where the model lies: on the card, every decode step's global
layers launch the block-sparse kernel; on the CPU they take its plain
version.  Every other model (Jamba, Mixtral, DeepSeek-V2's MLA, xLSTM)
runs unchanged: the mask words reach only the global layers, and the
paged-KV bookkeeping counts positions whatever the layers keep.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import RoaringBitmap, pairwise
from repro_torch.core.tensor import block_mask_words
from repro_torch.serve.constrained import VocabConstraint
from repro_torch.serve.kv_cache import PagedKVAllocator


@dataclasses.dataclass
class BlockPolicy:
    """Which KV blocks stay visible for long-context decode."""
    sink_blocks: int = 1          # always keep the first blocks
    local_blocks: int = 8         # sliding window of recent blocks
    pinned: RoaringBitmap | None = None   # retrieval-pinned blocks

    def visible_set(self, kv_len: int, block_size: int, *,
                    device=None) -> RoaringBitmap:
        """The visible blocks of a sequence of ``kv_len`` tokens; the set
        algebra runs on ``device`` (the card unless the caller names
        another)."""
        n_blocks = max(1, -(-kv_len // block_size))
        sink = RoaringBitmap.from_range(0, min(self.sink_blocks, n_blocks))
        lo = max(0, n_blocks - self.local_blocks)
        local = RoaringBitmap.from_range(lo, n_blocks)
        vis = pairwise.merge_one(sink, local, "or", device=device)
        if self.pinned is not None:
            vis = pairwise.merge_one(vis, self.pinned, "or", device=device)
        return vis


class Engine:
    """Serves ``model`` (a ``models.transformer.Transformer``, whose
    ``cfg`` it reads) on the model's device; the JAX package's engine takes
    the config and the parameter tree instead.  ``greedy=False`` samples
    with ``torch.multinomial`` from the engine's generator, seeded with
    ``seed``."""

    def __init__(self, model, max_seq: int,
                 policy: BlockPolicy | None = None,
                 constraint: VocabConstraint | None = None,
                 page_size: int = 128, greedy: bool = True, seed: int = 0):
        self.cfg = cfg = model.cfg
        self.model = model
        self.device = model.device
        self.max_seq = max_seq
        self.policy = policy or BlockPolicy()
        self.constraint = constraint
        self.greedy = greedy
        self.generator = torch.Generator(self.device).manual_seed(seed)
        self.allocator = PagedKVAllocator(
            n_pages=max(64, 4 * max_seq // page_size), page_size=page_size,
            device=self.device)
        self.n_blocks = max(1, max_seq // cfg.attn_block_size)
        self._mask_cache: dict[tuple[int, ...], torch.Tensor] = {}

    def _mask_words(self, kv_lens: list[int]) -> torch.Tensor:
        """Visible-block mask words, cached on the per-request block counts.

        The visible set depends on kv_len only through
        ceil(kv_len / block_size), so consecutive decode steps inside one
        attention block hit the cache instead of rebuilding Roaring sets and
        re-rendering words every token.  (Mutating ``policy.pinned`` in
        place will not invalidate the cache; swap the policy or Engine to
        change pinning mid-stream.)"""
        bs = self.cfg.attn_block_size
        key = tuple(-(-kl // bs) for kl in kv_lens)
        mask = self._mask_cache.get(key)
        if mask is None:
            if len(self._mask_cache) > 512:        # bound decode-long growth
                self._mask_cache.clear()
            sets = [self.policy.visible_set(kl, bs, device=self.device)
                    for kl in kv_lens]
            mask = self._mask_cache[key] = block_mask_words(
                sets, self.n_blocks, device=self.device)
        return mask

    def generate(self, prompts: np.ndarray, max_new_tokens: int) -> np.ndarray:
        """prompts: (B, S0) int32 -> (B, max_new_tokens) int32.  Every new
        token runs one decode step (the last one's logits go unused, as in
        the JAX package).  The prompt and the new tokens must fit
        ``max_seq`` cache positions."""
        b, s0 = prompts.shape
        if s0 + max_new_tokens > self.max_seq:
            raise ValueError(f"{s0} prompt + {max_new_tokens} new tokens "
                             f"exceed max_seq {self.max_seq}")
        for i in range(b):
            self.allocator.extend(i, s0)
        logits, state = self.model.prefill(
            torch.as_tensor(np.asarray(prompts), device=self.device),
            s_max=self.max_seq)
        out = np.zeros((b, max_new_tokens), np.int32)
        tok = self._select(logits)
        for t in range(max_new_tokens):
            out[:, t] = tok.cpu().numpy()
            kv_lens = [s0 + t + 1] * b
            for i in range(b):
                self.allocator.extend(i, kv_lens[i])
            mask = self._mask_words(kv_lens)
            logits, state = self.model.decode_step(state, tok, mask)
            tok = self._select(logits)
        return out

    def _select(self, logits: torch.Tensor) -> torch.Tensor:
        if self.constraint is not None:
            logits = self.constraint.apply(logits)
        if self.greedy:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        probs = torch.softmax(logits.float(), dim=-1)
        return torch.multinomial(probs, 1, generator=self.generator)[
            :, 0].to(torch.int32)

    def release_all(self):
        for sid in list(self.allocator.tables):
            self.allocator.release(sid)

"""Serving telemetry: per-ticket query timings for the continuous query
server, plus MoE routing telemetry on Roaring sets (paper section 5.9
fast counts), the port of the JAX package's ``repro/serve/telemetry.py``.

Query-server side: every resolved ticket carries a ``QueryTelemetry``
(queue time, dispatch latency, retries, degradation flags), and the
server keeps a running ``ServerStats`` -- the counters the fault-injection
tests and ``chip_smoke.py`` assert against.

MoE side: each expert's routed-token-id set is a ``RoaringBitmap``
(``routing_sets`` of a MoE layer's ``expert_idx``); load balance, expert
overlap (Jaccard) and drift between steps (symmetric difference) are the
paper's count-only operations, computed without materializing the
intermediate sets, on ``device`` (the card unless the caller names
another).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import RoaringBitmap


@dataclasses.dataclass
class QueryTelemetry:
    """Per-ticket timing and failure-handling record, attached to every
    resolved ticket (including structured rejections)."""
    submitted_at: float = 0.0
    dispatched_at: float | None = None      # None: never reached dispatch
    resolved_at: float = 0.0
    batch_size: int = 0                     # tickets in the ticket's batch
    retries: int = 0                        # failed kernel attempts
    splits: int = 0                         # alloc-pressure batch splits
    replans: int = 0                        # slab-mismatch re-plans
    degraded: bool = False                  # resolved on the host path

    @property
    def queue_time(self) -> float:
        """Admission -> dispatch (or rejection) wait."""
        end = (self.dispatched_at if self.dispatched_at is not None
               else self.resolved_at)
        return end - self.submitted_at

    @property
    def latency(self) -> float:
        """Admission -> resolution, the caller-visible total."""
        return self.resolved_at - self.submitted_at


@dataclasses.dataclass
class ServerStats:
    """Monotone counters over a server's lifetime (``QueryServer.stats``
    returns a snapshot copy)."""
    submitted: int = 0
    rejected_overloaded: int = 0
    rejected_invalid: int = 0
    resolved_ok: int = 0
    resolved_error: int = 0
    deadline_expired: int = 0
    ticks: int = 0
    batches: int = 0
    dispatch_retries: int = 0
    batch_splits: int = 0
    replans: int = 0
    rows_repatched: int = 0     # arena rows repatched by replan rungs
    host_fallbacks: int = 0
    max_batch: int = 0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def routing_sets(expert_idx, n_experts: int) -> list[RoaringBitmap]:
    """expert_idx: (tokens, top_k) ints (numpy or a tensor on any device)
    -> the per-expert token-id bitmaps."""
    if isinstance(expert_idx, torch.Tensor):
        expert_idx = expert_idx.cpu().numpy()
    expert_idx = np.asarray(expert_idx)
    flat_tok = np.repeat(np.arange(expert_idx.shape[0], dtype=np.uint32),
                         expert_idx.shape[1])
    flat_e = expert_idx.reshape(-1)
    return [RoaringBitmap.from_values(flat_tok[flat_e == e])
            for e in range(n_experts)]


def load_balance_stats(sets: list[RoaringBitmap]) -> dict:
    loads = np.array([bm.cardinality for bm in sets], np.float64)
    total = loads.sum()
    frac = loads / max(total, 1)
    e = len(sets)
    return {
        "max_load_fraction": float(frac.max()),
        "cv": float(loads.std() / max(loads.mean(), 1e-9)),
        "entropy_ratio": float(
            -(frac[frac > 0] * np.log(frac[frac > 0])).sum() / np.log(e)),
    }


def expert_overlap_matrix(sets: list[RoaringBitmap], *,
                          device=None) -> np.ndarray:
    """Pairwise Jaccard between experts' token sets (fast counts)."""
    e = len(sets)
    out = np.zeros((e, e))
    for i in range(e):
        for j in range(i, e):
            out[i, j] = out[j, i] = sets[i].jaccard(sets[j], device=device)
    return out


def routing_drift(prev: list[RoaringBitmap], cur: list[RoaringBitmap], *,
                  device=None) -> np.ndarray:
    """Per-expert symmetric-difference cardinality between steps,
    normalized by union -- 0 = stable routing, 1 = fully churned."""
    out = np.zeros(len(cur))
    for i, (a, b) in enumerate(zip(prev, cur)):
        union = a.or_card(b, device=device)
        out[i] = a.xor_card(b, device=device) / union if union else 0.0
    return out

"""Serving telemetry for the continuous query server: every resolved
ticket carries a ``QueryTelemetry`` (queue time, dispatch latency,
retries, degradation flags), and the server keeps a running
``ServerStats`` -- the counters the fault-injection tests and
``chip_smoke.py`` assert against.
"""

from __future__ import annotations

import dataclasses


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

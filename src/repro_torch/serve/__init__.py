"""repro_torch.serve -- the continuous query server over the port's
inverted index, and the model serving engine.

``query_server`` is the fault-tolerant continuous batcher (coalesced
multi-query launches, admission control, deadlines, kernel -> host
degradation); ``faults`` its deterministic fault-injection harness;
``telemetry`` the per-ticket and per-server records and the MoE routing
telemetry.  ``engine`` is the
batched prefill -> decode loop with Roaring block-visibility sets,
``kv_cache`` its paged KV allocator and ``constrained`` its vocabulary
constraints.
"""

from repro_torch.serve.constrained import (VocabConstraint,
                                           lexicon_constraint)
from repro_torch.serve.engine import BlockPolicy, Engine
from repro_torch.serve.faults import (AllocPressure, DispatchFault,
                                      FakeClock, FaultError, FaultInjector,
                                      SlabMismatch, SystemClock)
from repro_torch.serve.kv_cache import PagedKVAllocator
from repro_torch.serve.query_server import (DEADLINE, ERROR, INVALID, OK,
                                            OVERLOADED, Query, QueryServer,
                                            Ticket, TicketResult)
from repro_torch.serve.telemetry import (QueryTelemetry, ServerStats,
                                         expert_overlap_matrix,
                                         load_balance_stats, routing_drift,
                                         routing_sets)

__all__ = [
    "Query", "QueryServer", "Ticket", "TicketResult",
    "OK", "OVERLOADED", "INVALID", "DEADLINE", "ERROR",
    "FaultError", "DispatchFault", "SlabMismatch", "AllocPressure",
    "FaultInjector", "FakeClock", "SystemClock",
    "QueryTelemetry", "ServerStats", "routing_sets", "load_balance_stats",
    "expert_overlap_matrix", "routing_drift",
    "BlockPolicy", "Engine", "PagedKVAllocator", "VocabConstraint",
    "lexicon_constraint",
]

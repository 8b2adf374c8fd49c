"""repro_torch.serve -- the continuous query server over the port's
inverted index.

``query_server`` is the fault-tolerant continuous batcher (coalesced
multi-query launches, admission control, deadlines, kernel -> host
degradation); ``faults`` its deterministic fault-injection harness;
``telemetry`` the per-ticket and per-server records.
"""

from repro_torch.serve.faults import (AllocPressure, DispatchFault,
                                      FakeClock, FaultError, FaultInjector,
                                      SlabMismatch, SystemClock)
from repro_torch.serve.query_server import (DEADLINE, ERROR, INVALID, OK,
                                            OVERLOADED, Query, QueryServer,
                                            Ticket, TicketResult)
from repro_torch.serve.telemetry import QueryTelemetry, ServerStats

__all__ = [
    "Query", "QueryServer", "Ticket", "TicketResult",
    "OK", "OVERLOADED", "INVALID", "DEADLINE", "ERROR",
    "FaultError", "DispatchFault", "SlabMismatch", "AllocPressure",
    "FaultInjector", "FakeClock", "SystemClock",
    "QueryTelemetry", "ServerStats",
]

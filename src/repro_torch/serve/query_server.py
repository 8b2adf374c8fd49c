"""Fault-tolerant continuous query server over a warm inverted index: the
port of the JAX package's ``serve/query_server.py`` on one device.

The paper's adopters (Druid, Pinot, Elasticsearch) serve thousands of
concurrent queries against one shared index; this module is that serving
layer, shaped like an inference server's continuous batcher: callers
``submit`` queries and get tickets back immediately, and each engine tick
coalesces everything queued into one ``segment_reduce`` launch per op class
(``core.aggregate.execute_plans`` -- a query id is just another segment
coordinate) plus one ``SimilarityEngine.topk_batch`` per (k, metric)
similarity class over the cached candidate rows (each query runs its own
score and select launches).  The server runs on its index's device.

Robustness contract (the point of the module):

* **Admission control** -- the queue is bounded; tickets beyond
  ``max_queue`` resolve immediately with a structured ``OVERLOADED``
  result.  Malformed queries resolve ``INVALID`` at submit time (the
  planner validates at admission, never inside a batch).
* **Deadlines** -- enforced at admission, at batch formation, and after
  dispatch: a ticket that misses its deadline resolves ``DEADLINE``;
  a hung dispatch can overrun but never lose the ticket.
* **Retry with backoff** -- transient dispatch failures retry up to
  ``max_retries`` times with exponential backoff (through the injected
  clock, so tests never sleep).
* **Batch splitting** -- allocator pressure (injected, or the card's
  out-of-memory error) halves the batch and retries the halves
  independently before giving up on the kernel.
* **Graceful degradation** -- a batch whose dispatch keeps failing with
  ``DispatchFault``, or a single ticket under allocator pressure,
  reroutes to the numpy-only host planner (``execute_plan_host`` / the
  pruned host top-k sweep), which is bit-identical to the kernel path by
  construction; the ticket's telemetry flags ``degraded`` and
  ``ServerStats.host_fallbacks`` counts it.
* **No hidden fallback** -- any other failure of the dispatch (a kernel
  that does not build, does not launch, or traps) resolves every ticket
  of the batch ``ERROR`` with the exception's text.  It is neither
  retried nor served from the host: the server's answers come from the
  kernels, or the ticket says they did not.
* **Zero lost tickets** -- every admitted ticket resolves with a value
  or a structured error; no exception escapes ``step``.

Failure handling is scripted and testable through ``serve.faults``.
"""

from __future__ import annotations

import dataclasses
from collections import deque

import torch

from repro_torch.core import aggregate
from repro_torch.kernels.ref import METRICS
from repro_torch.serve.faults import (AllocPressure, DispatchFault,
                                      FaultInjector, SystemClock)
from repro_torch.serve.telemetry import QueryTelemetry, ServerStats

__all__ = ["Query", "Ticket", "TicketResult", "QueryServer",
           "OK", "OVERLOADED", "INVALID", "DEADLINE", "ERROR"]

BOOLEAN_KINDS = ("and", "or", "xor", "andnot", "threshold")

# ticket terminal statuses
OK = "ok"                 # value holds the query result
OVERLOADED = "overloaded"  # shed at admission: queue full
INVALID = "invalid"       # rejected at admission: malformed query
DEADLINE = "deadline"     # missed its deadline (admission or dispatch)
ERROR = "error"           # unexpected failure after all recovery paths

# nominal admission-queue byte charge for a similarity ticket: one query
# block row -- the real cost is the shared resident slab, already paid
_SIM_BYTES = 8192


@dataclasses.dataclass(frozen=True)
class Query:
    """One query: a boolean aggregate over terms or a similarity top-k.

    ``kind`` is "and" | "or" | "xor" | "andnot" | "threshold" |
    "similar".  For "andnot" the first term is the minuend; "threshold"
    uses ``t``/``weights`` (see ``threshold_many``); "similar" queries
    ``terms[0]`` with ``k``/``metric``."""
    kind: str
    terms: tuple
    t: int = 0
    weights: tuple | None = None
    k: int = 10
    metric: str = "jaccard"

    @classmethod
    def and_(cls, *terms): return cls("and", terms)

    @classmethod
    def or_(cls, *terms): return cls("or", terms)

    @classmethod
    def xor_(cls, *terms): return cls("xor", terms)

    @classmethod
    def andnot(cls, keep, *drops): return cls("andnot", (keep, *drops))

    @classmethod
    def threshold(cls, terms, t, weights=None):
        return cls("threshold", tuple(terms), t,
                   None if weights is None else tuple(weights))

    @classmethod
    def similar(cls, term, k=10, metric="jaccard"):
        return cls("similar", (term,), k=k, metric=metric)


@dataclasses.dataclass
class TicketResult:
    """Terminal outcome: ``status`` is one of the module constants;
    ``value`` is the query result when status is OK (a RoaringBitmap,
    or ``[(term, score)]`` for similarity); ``error`` a diagnostic."""
    status: str
    value: object = None
    error: str = ""

    @property
    def ok(self) -> bool:
        return self.status == OK


class Ticket:
    """Handle returned by ``submit``: resolves exactly once, to a
    ``TicketResult``, with per-query ``QueryTelemetry`` attached."""

    __slots__ = ("id", "query", "deadline", "telemetry", "result",
                 "_plan", "_value", "_error")

    def __init__(self, tid: int, query: Query, deadline: float | None,
                 submitted_at: float):
        self.id = tid
        self.query = query
        self.deadline = deadline                  # absolute clock time
        self.telemetry = QueryTelemetry(submitted_at=submitted_at)
        self.result: TicketResult | None = None
        self._plan = None                         # WidePlan (boolean)
        self._value = None
        self._error: str | None = None

    @property
    def done(self) -> bool:
        return self.result is not None


class QueryServer:
    """Continuous batcher over an ``InvertedIndex``.

    Synchronous and single-threaded by design: ``submit`` enqueues (or
    sheds) and ``step`` runs one engine tick -- form a batch, coalesce,
    dispatch, resolve.  Tests drive ticks directly with a fake clock;
    a production loop is ``while True: server.step()``.

    Parameters: ``backend`` forwards to the kernel wrappers (None /
    "cuda" / "ref", as in ``kernels.ops``); ``max_queue`` bounds
    admission; ``max_batch`` / ``max_batch_bytes`` bound one tick's
    coalesced slab; ``max_retries``
    kernel re-attempts before host degradation; ``backoff_s`` base of
    the exponential retry backoff; ``clock`` an object with ``now()`` /
    ``sleep(s)`` (``FakeClock`` in tests); ``faults`` a
    ``serve.faults.FaultInjector``.  The server uses its index's arena,
    when it has one: postings stay device-resident across ticks and the
    ``slab_mismatch`` recovery rung revalidates generations (repatching
    only edited rows) instead of dropping the cached engine.  The JAX
    package's ``mesh=`` (sharded serving) is not ported."""

    def __init__(self, index, *, backend: str | None = None,
                 max_queue: int = 4096, max_batch: int = 1024,
                 max_batch_bytes: int = 256 << 20, max_retries: int = 2,
                 backoff_s: float = 0.005, clock=None, faults=None):
        self.index = index
        self.backend = backend
        self.arena = index.arena
        self.max_queue = int(max_queue)
        self.max_batch = int(max_batch)
        self.max_batch_bytes = int(max_batch_bytes)
        self.max_retries = int(max_retries)
        self.backoff_s = float(backoff_s)
        self._clock = clock if clock is not None else SystemClock()
        self._faults = faults if faults is not None else FaultInjector()
        self._queue: deque[Ticket] = deque()
        self._stats = ServerStats()
        self._next_id = 0

    # -- admission -------------------------------------------------------

    def submit(self, query: Query, deadline_s: float | None = None
               ) -> Ticket:
        """Admit one query; never raises for query content.

        Returns a ticket that is either queued (``done`` False) or
        already resolved with a structured rejection: ``INVALID`` for
        malformed queries (validated by the planner here, at admission),
        ``DEADLINE`` for an already-expired deadline, ``OVERLOADED``
        when the queue is full (load shedding)."""
        now = self._clock.now()
        t = Ticket(self._next_id, query,
                   None if deadline_s is None else now + deadline_s, now)
        self._next_id += 1
        self._stats.submitted += 1
        try:
            self._admit_plan(t)
        except (ValueError, IndexError, TypeError) as e:
            self._resolve(t, INVALID, error=str(e))
            return t
        if t.deadline is not None and now > t.deadline:
            self._resolve(t, DEADLINE,
                          error="deadline expired at admission")
            return t
        if len(self._queue) >= self.max_queue:
            self._resolve(t, OVERLOADED,
                          error=f"queue full ({self.max_queue})")
            return t
        self._queue.append(t)
        return t

    def _admit_plan(self, t: Ticket) -> None:
        """Validate + plan at admission (planner errors surface here,
        never inside a coalesced batch)."""
        q = t.query
        if q.kind in BOOLEAN_KINDS:
            bms = [self.index._get(x) for x in q.terms]
            if self.arena is not None:
                for bm in bms:
                    if bm.containers:
                        self.arena.adopt(bm)
            t._plan = aggregate.plan_wide(
                q.kind, bms, q.t, q.weights, backend=self.backend,
                arena=self.arena, device=self.index.device)
        elif q.kind == "similar":
            if q.metric not in METRICS:
                raise ValueError(f"unknown metric {q.metric!r}")
            if len(q.terms) != 1:
                raise ValueError("similar takes exactly one term")
        else:
            raise ValueError(f"unknown query kind {q.kind!r}")

    @property
    def pending(self) -> int:
        return len(self._queue)

    def stats(self) -> ServerStats:
        return dataclasses.replace(self._stats)

    # -- the engine tick -------------------------------------------------

    def step(self) -> int:
        """One tick: form a batch (max-batch / max-bytes policy),
        enforce deadlines at the dispatch boundary, coalesce into one
        dispatch per op class, resolve every ticket taken.  Returns the
        number of tickets resolved.  Never raises: unexpected failures
        resolve their tickets with status ``ERROR``."""
        self._stats.ticks += 1
        if not self._queue:
            return 0
        batch: list[Ticket] = []
        nbytes = 0
        while self._queue and len(batch) < self.max_batch:
            t = self._queue[0]
            b = (t._plan.slab_bytes() if t._plan is not None
                 else _SIM_BYTES)
            if batch and nbytes + b > self.max_batch_bytes:
                break
            self._queue.popleft()
            batch.append(t)
            nbytes += b
        now = self._clock.now()
        live: list[Ticket] = []
        for t in batch:
            if t.deadline is not None and now > t.deadline:
                self._resolve(t, DEADLINE,
                              error="deadline expired in queue")
            else:
                live.append(t)
        if not live:
            return len(batch)
        self._stats.batches += 1
        self._stats.max_batch = max(self._stats.max_batch, len(live))
        for t in live:
            t.telemetry.dispatched_at = now
            t.telemetry.batch_size = len(live)
        if self._faults.fire("slab_mismatch"):
            self._replan(live)
        self._execute(live)
        for t in live:
            if t._error is not None:
                self._resolve(t, ERROR, error=t._error)
            elif t.deadline is not None and \
                    self._clock.now() > t.deadline:
                self._resolve(t, DEADLINE,
                              error="deadline overrun at dispatch")
            else:
                self._resolve(t, OK, value=t._value)
        return len(batch)

    def run_until_idle(self, max_ticks: int = 1_000_000) -> int:
        """Tick until the queue drains; returns tickets resolved."""
        n = 0
        for _ in range(max_ticks):
            if not self._queue:
                break
            n += self.step()
        return n

    # -- dispatch, retry, degrade ---------------------------------------

    def _replan(self, tickets: list[Ticket]) -> None:
        """Slab-generation mismatch: re-plan every boolean ticket from
        the live postings, then carry on -- a mismatch is a re-plan,
        never a failure.

        With a warm arena this rung is INCREMENTAL: registered bitmaps
        revalidate their generation counters and only rows whose
        containers actually changed repatch (one scatter), and the
        similarity engine refreshes in place through the same arena view
        (``_sim_engine``) -- the cached slab is never dropped.  Without
        an arena it falls back to dropping the similarity slab cache
        wholesale."""
        self._stats.replans += 1
        if self.arena is not None:
            self._stats.rows_repatched += self.arena.revalidate()
        else:
            self.index._sim = None
        for t in tickets:
            t.telemetry.replans += 1
            if t.query.kind in BOOLEAN_KINDS:
                self._admit_plan(t)

    def _kernel_batch(self, tickets: list[Ticket]) -> None:
        """One coalesced kernel attempt for the whole batch; raises on
        (injected or real) dispatch failure.  Fault consultation order:
        allocator pressure (before any work), hang (stalls the clock),
        then the dispatch itself."""
        if self._faults.fire("alloc_pressure"):
            raise AllocPressure(f"batch of {len(tickets)} refused")
        hang = self._faults.fire("dispatch_hang")
        if hang:
            self._clock.sleep(float(hang))
        if self._faults.fire("dispatch_raise"):
            raise DispatchFault("injected dispatch failure")
        booleans = [t for t in tickets if t.query.kind in BOOLEAN_KINDS]
        sims = [t for t in tickets if t.query.kind == "similar"]
        if booleans:
            out = aggregate.execute_plans([t._plan for t in booleans],
                                          backend=self.backend)
            for t, bm in zip(booleans, out):
                t._value = bm
        if sims:
            terms, eng = self.index._sim_engine()
            by_class: dict[tuple, list[Ticket]] = {}
            for t in sims:
                by_class.setdefault((t.query.k, t.query.metric),
                                    []).append(t)
            for (k, metric), group in by_class.items():
                queries = [self._sim_query(t, terms) for t in group]
                res = eng.topk_batch(queries, k, metric,
                                     backend=self.backend)
                for t, (idx, score, _) in zip(group, res):
                    t._value = [(terms[i], float(s))
                                for i, s in zip(idx.tolist(),
                                                score.tolist())]

    def _sim_query(self, t: Ticket, terms: list):
        term = t.query.terms[0]
        if term in self.index.postings:
            return terms.index(term)
        return self.index._get(term)              # unknown: empty query

    def _execute(self, tickets: list[Ticket]) -> None:
        """Dispatch ``tickets`` with the recovery ladder: retry with
        backoff on a ``DispatchFault``, split on allocator pressure,
        degrade to the host planner when those keep failing.  Any other
        exception is a kernel fault and resolves the batch ``ERROR``,
        never on the host.  Postcondition: every ticket has ``_value``
        or ``_error`` set."""
        attempt = 0
        while True:
            try:
                self._kernel_batch(tickets)
                return
            except (AllocPressure, torch.cuda.OutOfMemoryError):
                self._stats.batch_splits += 1
                for t in tickets:
                    t.telemetry.splits += 1
                if len(tickets) > 1:
                    mid = len(tickets) // 2
                    self._execute(tickets[:mid])
                    self._execute(tickets[mid:])
                    return
                break                             # 1 ticket: degrade
            except DispatchFault:
                attempt += 1
                if attempt > self.max_retries:
                    break                         # degrade
                self._stats.dispatch_retries += 1
                for t in tickets:
                    t.telemetry.retries += 1
                self._clock.sleep(self.backoff_s * 2 ** (attempt - 1))
            except Exception as e:                # noqa: BLE001
                for t in tickets:
                    t._value = None
                    t._error = f"{type(e).__name__}: {e}"
                return
        self._host_batch(tickets)

    def _host_batch(self, tickets: list[Ticket]) -> None:
        """Graceful degradation: resolve each ticket on the numpy-only
        host planner (bit-identical to the kernel path by construction;
        see ``execute_plan_host``).  Per-ticket isolation: one bad query
        cannot take down its batchmates."""
        self._stats.host_fallbacks += 1
        sim_ctx = None
        for t in tickets:
            t.telemetry.degraded = True
            try:
                if t.query.kind in BOOLEAN_KINDS:
                    t._value = aggregate.execute_plan_host(t._plan)
                else:
                    if sim_ctx is None:
                        sim_ctx = self.index._sim_engine()
                    terms, eng = sim_ctx
                    idx, score, _ = eng.topk(
                        self._sim_query(t, terms), t.query.k,
                        t.query.metric, backend="host")
                    t._value = [(terms[i], float(s))
                                for i, s in zip(idx.tolist(),
                                                score.tolist())]
            except Exception as e:                # noqa: BLE001
                t._error = f"{type(e).__name__}: {e}"

    # -- resolution ------------------------------------------------------

    def _resolve(self, t: Ticket, status: str, value=None,
                 error: str = "") -> None:
        t.telemetry.resolved_at = self._clock.now()
        t.result = TicketResult(status, value, error)
        s = self._stats
        if status == OK:
            s.resolved_ok += 1
        elif status == OVERLOADED:
            s.rejected_overloaded += 1
        elif status == INVALID:
            s.rejected_invalid += 1
        elif status == DEADLINE:
            s.deadline_expired += 1
        else:
            s.resolved_error += 1

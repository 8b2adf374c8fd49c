"""Deterministic fault injection for the query server.

The server's robustness claims (retry-with-backoff, kernel->host
degradation, deadline enforcement, zero lost tickets) are only testable
if failures can be scripted exactly.  This module provides the three
pieces the tests wire through ``QueryServer``:

* ``FaultInjector`` -- named injection points (``SITES``) consulted by
  the server at every dispatch boundary.  Scripted mode replays an exact
  per-site sequence (fail-once-then-succeed is ``[True, False]``);
  seeded-random mode draws from a private ``random.Random`` so a run is
  reproducible from its seed alone.
* ``FaultError`` subclasses -- the transient failures the injector
  raises, kept distinct from real bugs so the server's catch-all can
  still report unexpected exceptions as such.
* ``FakeClock`` -- a manual clock + sleep pair so deadline and backoff
  tests advance virtual time instead of sleeping in CI.

Injection sites
---------------
``dispatch_raise``   the kernel batch raises mid-dispatch (transient).
``dispatch_hang``    the dispatch stalls; fires as a sleep of the
                     scripted duration, driving deadline overruns.
``slab_mismatch``    the planned slab no longer matches the index
                     generation (concurrent mutation); the server must
                     re-plan, not fail.
``alloc_pressure``   the batch is too large for the allocator; the
                     server must split it, then degrade to the host.
"""

from __future__ import annotations

import random
import time

SITES = ("dispatch_raise", "dispatch_hang", "slab_mismatch",
         "alloc_pressure")


class FaultError(Exception):
    """Base of all injected faults: transient by contract, so the server
    retries these before degrading."""


class DispatchFault(FaultError):
    """Injected kernel-dispatch failure (site ``dispatch_raise``)."""


class SlabMismatch(FaultError):
    """Planned slab went stale mid-batch (site ``slab_mismatch``)."""


class AllocPressure(FaultError):
    """Allocator refused the batch (site ``alloc_pressure``)."""


class SystemClock:
    """Real monotonic time + real sleep (the default outside tests)."""

    def now(self) -> float:
        return time.monotonic()

    def sleep(self, seconds: float) -> None:
        if seconds > 0:
            time.sleep(seconds)


class FakeClock:
    """Manual clock: ``sleep`` advances ``now`` instantly and records
    every call, so backoff schedules and deadline overruns are asserted
    without wall-clock delay."""

    def __init__(self, start: float = 0.0):
        self.t = float(start)
        self.sleeps: list[float] = []

    def now(self) -> float:
        return self.t

    def sleep(self, seconds: float) -> None:
        self.sleeps.append(float(seconds))
        self.t += max(0.0, float(seconds))

    def advance(self, seconds: float) -> None:
        self.t += float(seconds)


class FaultInjector:
    """Per-site fault schedule consulted by the server.

    ``fire(site)`` returns the next scripted value for ``site`` --
    falsy for "no fault", ``True`` to fault, a positive float for a
    hang duration -- consuming one schedule entry per call.  A site's
    schedule may be a finite sequence (exhausted -> no more faults) or
    the string ``"always"``.  ``FaultInjector()`` with no arguments
    never fires, so production servers pay one dict lookup per site.
    """

    def __init__(self, script: dict | None = None, *,
                 seed: int | None = None, rates: dict | None = None,
                 hang_s: float = 0.0):
        script = dict(script or {})
        rates = dict(rates or {})
        for site in list(script) + list(rates):
            if site not in SITES:
                raise ValueError(f"unknown fault site {site!r}; "
                                 f"sites: {SITES}")
        self._always = {s for s, v in script.items() if v == "always"}
        self._queues = {s: list(v) for s, v in script.items()
                        if v != "always"}
        self._rates = rates
        self._hang_s = float(hang_s)
        self._rng = random.Random(seed)
        self.fired: list[str] = []                # audit log for tests

    @classmethod
    def script(cls, script: dict) -> "FaultInjector":
        """Exact per-site schedules, e.g. fail-once-then-succeed:
        ``FaultInjector.script({"dispatch_raise": [True, False]})``."""
        return cls(script)

    @classmethod
    def random(cls, seed: int, rates: dict,
               hang_s: float = 0.0) -> "FaultInjector":
        """Seeded random faulting: ``rates`` maps site -> probability
        per consultation; ``hang_s`` is the duration when
        ``dispatch_hang`` fires."""
        return cls(seed=seed, rates=rates, hang_s=hang_s)

    def fire(self, site: str):
        if site in self._always:
            self.fired.append(site)
            return True
        q = self._queues.get(site)
        if q:
            v = q.pop(0)
            if v:
                self.fired.append(site)
            return v
        rate = self._rates.get(site, 0.0)
        if rate and self._rng.random() < rate:
            self.fired.append(site)
            return self._hang_s if site == "dispatch_hang" else True
        return False

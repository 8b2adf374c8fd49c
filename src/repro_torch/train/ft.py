"""Failure detection and straggler mitigation (host-side control plane), a
copy of the JAX package's ``repro/train/ft.py`` (pure Python).

  * HeartbeatMonitor -- hosts report heartbeats; a host silent for longer
    than `timeout_s` is declared failed, which triggers elastic replanning
    (train/elastic.py) and a checkpoint restore (train/checkpoint.py).
  * StragglerPolicy  -- tracks per-host step durations with an EWMA; hosts
    slower than `ratio` x the fleet median for `patience` consecutive steps
    are flagged.  The mitigation is deadline-skip: the flagged host's
    microbatch is dropped for the step and the gradient denominator is
    adjusted (`scale_for_skipped`).
"""

from __future__ import annotations

import dataclasses
import statistics


@dataclasses.dataclass
class HeartbeatMonitor:
    timeout_s: float = 30.0
    _last: dict = dataclasses.field(default_factory=dict)

    def beat(self, host: str, now: float):
        self._last[host] = now

    def failed_hosts(self, now: float) -> list[str]:
        return sorted(h for h, t in self._last.items()
                      if now - t > self.timeout_s)

    def alive_hosts(self, now: float) -> list[str]:
        return sorted(h for h, t in self._last.items()
                      if now - t <= self.timeout_s)


@dataclasses.dataclass
class StragglerPolicy:
    ratio: float = 1.8          # flag when slower than ratio x median
    patience: int = 3           # for this many consecutive steps
    ewma: float = 0.5
    _dur: dict = dataclasses.field(default_factory=dict)
    _strikes: dict = dataclasses.field(default_factory=dict)

    def observe(self, host: str, step_seconds: float):
        prev = self._dur.get(host)
        self._dur[host] = step_seconds if prev is None else \
            self.ewma * step_seconds + (1 - self.ewma) * prev

    def stragglers(self) -> list[str]:
        if len(self._dur) < 2:
            return []
        med = statistics.median(self._dur.values())
        out = []
        for host, d in self._dur.items():
            if d > self.ratio * med:
                self._strikes[host] = self._strikes.get(host, 0) + 1
            else:
                self._strikes[host] = 0
            if self._strikes.get(host, 0) >= self.patience:
                out.append(host)
        return sorted(out)

    @staticmethod
    def scale_for_skipped(n_total: int, n_skipped: int) -> float:
        """Gradient rescale when skipping stragglers' microbatches: the mean
        over contributing shards stays unbiased."""
        contributing = max(n_total - n_skipped, 1)
        return n_total / contributing

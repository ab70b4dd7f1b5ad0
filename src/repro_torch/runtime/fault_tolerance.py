"""Fault-tolerance runtime: preemption, heartbeats, straggler mitigation,
elastic rescale decisions.

Port of ``repro.runtime.fault_tolerance`` (the standard library only, the
same behaviour).  These are host-side mechanisms of the serving loop
around the device work; the tests exercise them deterministically with
simulated clocks and failures.
"""

from __future__ import annotations

import dataclasses
import signal
import time
from collections import deque
from typing import Callable, Optional

from repro_torch.core.errors import MeshShrinkError


@dataclasses.dataclass
class PreemptionHandler:
    """SIGTERM -> finish current step -> checkpoint -> exit cleanly.

    The cooperative-preemption contract the session serving loop implements
    (``core.durability`` + ``launch/serve.py``): the signal handler only sets
    a flag; the serving loop polls ``should_stop`` at scan-chunk boundaries, drains
    in-flight chunks, checkpoints at the superstep boundary it landed on,
    and exits 0.  ``request()`` sets the same flag without a signal, so tests
    exercise the full drain/checkpoint path deterministically.
    """

    signals: tuple = (signal.SIGTERM,)
    _requested: bool = False
    _installed: bool = False

    def __post_init__(self):
        self._previous: dict = {}

    def install(self):
        if not self._installed:
            for sig in self.signals:
                self._previous[sig] = signal.signal(sig, self._on_signal)
            self._installed = True
        return self

    def uninstall(self):
        """Restore the handlers ``install`` displaced (idempotent) — so a
        scoped serving loop doesn't leave its flag-setter wired into an
        embedding process's signal table after it returns."""
        if self._installed:
            for sig, prev in self._previous.items():
                signal.signal(sig, prev if prev is not None else signal.SIG_DFL)
            self._previous = {}
            self._installed = False
        return self

    def _on_signal(self, signum, frame):
        self._requested = True

    def request(self):  # test hook / cooperative preemption
        self._requested = True

    @property
    def should_stop(self) -> bool:
        return self._requested


@dataclasses.dataclass
class Heartbeat:
    """Driver-side liveness tracking of worker shards.

    A worker that misses ``timeout_s`` is declared failed; the serving loop then
    triggers restore-from-checkpoint on a shrunken mesh (elastic restart).

    Membership is explicit: ``beat`` refuses worker ids it is not tracking
    (a silent insert would mask bookkeeping bugs — e.g. beating the
    pre-shrink worker numbering after an elastic restart).  The serving loop
    acknowledges a declared failure with ``remove`` (so ``failed_workers``
    stops re-reporting it) and re-admits a worker with ``revive``."""

    num_workers: int
    timeout_s: float = 60.0
    clock: Callable[[], float] = time.monotonic

    def __post_init__(self):
        now = self.clock()
        self.last_seen = {w: now for w in range(self.num_workers)}

    def beat(self, worker: int, at: Optional[float] = None):
        if worker not in self.last_seen:
            raise KeyError(
                f"heartbeat from unknown worker {worker}; tracking "
                f"{sorted(self.last_seen)} of {self.num_workers} allocated "
                f"(use revive() to rejoin a removed worker)"
            )
        self.last_seen[worker] = self.clock() if at is None else at

    def remove(self, worker: int):
        """Acknowledge a failure: stop tracking ``worker`` until revived."""
        if worker not in self.last_seen:
            raise KeyError(f"cannot remove untracked worker {worker}")
        del self.last_seen[worker]

    def revive(self, worker: int):
        """Explicit rejoin: (re)track ``worker`` as healthy as of now.

        The id must be within the allocated range — revive re-admits a
        removed or timed-out worker, it does not grow the worker set."""
        if not 0 <= worker < self.num_workers:
            raise KeyError(
                f"cannot revive worker {worker}: allocated range is "
                f"[0, {self.num_workers})"
            )
        self.last_seen[worker] = self.clock()

    def failed_workers(self) -> list[int]:
        now = self.clock()
        return [w for w, t in self.last_seen.items() if now - t > self.timeout_s]

    def healthy(self) -> bool:
        return not self.failed_workers()


@dataclasses.dataclass
class StragglerMonitor:
    """Per-shard step-time EMAs -> object-partition rebalancing weights.

    PIQUE serving is bulk-synchronous per epoch: the epoch takes as long as
    its slowest shard.  The monitor tracks an EMA of per-shard epoch times
    and emits partition weights inversely proportional to measured speed;
    the serving loop reassigns object ranges accordingly (and the trainer
    uses the same signal to shrink a straggler's microbatch count)."""

    num_shards: int
    ema: float = 0.3
    history: int = 32

    def __post_init__(self):
        self.times = [None] * self.num_shards
        self.recent: deque = deque(maxlen=self.history)

    def record(self, shard: int, seconds: float):
        prev = self.times[shard]
        self.times[shard] = (
            seconds if prev is None else (1 - self.ema) * prev + self.ema * seconds
        )
        self.recent.append((shard, seconds))

    def speeds(self) -> list[float]:
        filled = [t for t in self.times if t is not None]
        default = sum(filled) / len(filled) if filled else 1.0
        return [1.0 / (t if t is not None else default) for t in self.times]

    def partition_weights(self) -> list[float]:
        s = self.speeds()
        tot = sum(s)
        return [x / tot for x in s]

    def stragglers(self, factor: float = 1.5) -> list[int]:
        filled = [t for t in self.times if t is not None]
        if len(filled) < 2:
            return []
        med = sorted(filled)[len(filled) // 2]
        return [
            i for i, t in enumerate(self.times)
            if t is not None and t > factor * med
        ]

    def rebalance_objects(self, num_objects: int) -> list[tuple[int, int]]:
        """-> per-shard [start, end) ranges proportional to speed.

        Cut points come from the *cumulative* weight (clamped monotone into
        ``[start, num_objects]``), so per-shard rounding cannot accumulate:
        the ranges are always non-negative, disjoint, and cover exactly
        ``[0, num_objects)`` — a fast shard can round to an empty range, but
        the last shard can never go negative."""
        w = self.partition_weights()
        bounds = []
        start = 0
        cum = 0.0
        for i, wi in enumerate(w):
            cum += wi
            if i == self.num_shards - 1:
                end = num_objects
            else:
                end = min(num_objects, max(start, int(round(cum * num_objects))))
            bounds.append((start, end))
            start = end
        return bounds


@dataclasses.dataclass
class ElasticPolicy:
    """Decide the new mesh when workers fail (power-of-two data shrink)."""

    data_axis: int
    model_axis: int

    def shrink_for_failures(self, healthy_chips: int) -> tuple[int, int]:
        """Keep the model axis intact (TP is wired to the layout); shrink the
        data axis to the largest power of two that fits healthy chips."""
        data = self.data_axis
        while data * self.model_axis > healthy_chips and data > 1:
            data //= 2
        if data * self.model_axis > healthy_chips:
            raise MeshShrinkError(
                f"cannot fit model axis {self.model_axis} on {healthy_chips} chips",
                healthy_chips=healthy_chips,
                model_axis=self.model_axis,
            )
        return data, self.model_axis

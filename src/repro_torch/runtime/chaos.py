"""Deterministic fault injection for the supervised serving runtime.

Port of ``repro.runtime.chaos`` (numpy and the standard library only): the
same grammar and the same seeded ``auto`` boundaries, so one spec and seed
schedule the same faults in both packages.

A ``FaultPlan`` schedules failures at named *chunk boundaries* — the logical
clock of the serving loop (one tick per dispatched scan chunk, monotone
across supervisor restarts) — so every chaos run is exactly reproducible:
the same spec and seed produce the same failure at the same superstep
boundary, and the recovery gate can diff digests against an uninterrupted
control run byte-for-byte.

Spec grammar (``launch/serve.py --inject-faults``)::

    SPEC    := EVENT (';' EVENT)*
    EVENT   := 'kill:w' W '@chunk:' B                 # worker dies (permanent)
             | 'silence:w' W '@chunk:' B ['+' D]      # misses beats for D
             | 'slow:w' W ['*' X] '@chunk:' B ['+' D] # step time inflated X-fold
             | 'raise:p' P '.f' F '@chunk:' B ['+' D] # enrichment fn raises
    B       := INT | 'auto'                           # auto: seeded draw

``+D`` bounds the fault window to D boundaries (omitted = permanent).  A
``raise`` with a window models a transiently-failing enrichment function:
the supervisor's breaker probes it on exponential backoff and un-quarantines
once a probe lands past the window.  ``auto`` boundaries draw uniformly from
``[1, horizon]`` with the plan's seed — chaos soaks without hand-placing
every event.

The plan is pure bookkeeping: ``kill``/``raise`` onsets fire exactly once
(``due``), while ``silence``/``slow``/``raise`` windows are queried
statelessly (``silenced`` / ``slow_factor`` / ``raising``).  The supervisor
(``runtime.supervisor``) turns these into missed heartbeats, inflated
straggler timings, and quarantine transitions.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Optional

import numpy as np

__all__ = ["FaultEvent", "FaultPlan", "parse_fault_spec"]


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault (see module grammar)."""

    kind: str  # "kill" | "silence" | "slow" | "raise"
    boundary: int  # chunk boundary the fault starts at (1-based)
    worker: Optional[int] = None  # kill / silence / slow
    pred: Optional[int] = None  # raise
    func: Optional[int] = None  # raise
    duration: Optional[int] = None  # window in boundaries; None = permanent
    factor: float = 4.0  # slow: step-time multiplier

    def __post_init__(self):
        if self.kind not in ("kill", "silence", "slow", "raise"):
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if self.boundary < 1:
            raise ValueError(f"fault boundary must be >= 1, got {self.boundary}")
        if self.duration is not None and self.duration < 1:
            raise ValueError(f"fault duration must be >= 1, got {self.duration}")

    def in_window(self, boundary: int) -> bool:
        if boundary < self.boundary:
            return False
        return self.duration is None or boundary < self.boundary + self.duration


class FaultPlan:
    """A seeded, ordered schedule of ``FaultEvent``s.

    ``due(boundary)`` consumes one-shot arrivals (``kill`` and ``raise``
    onsets) at-or-before the boundary exactly once — restart-safe because the
    boundary clock never rewinds.  Window queries are stateless.
    """

    def __init__(self, events, seed: int = 0):
        self.events: list[FaultEvent] = sorted(events, key=lambda e: e.boundary)
        self.seed = int(seed)
        self._fired: set = set()

    def __len__(self) -> int:
        return len(self.events)

    def due(self, boundary: int) -> list[FaultEvent]:
        """One-shot arrivals (kill / raise onsets) newly due at ``boundary``."""
        out = []
        for i, ev in enumerate(self.events):
            if ev.boundary > boundary:
                break
            if i in self._fired or ev.kind not in ("kill", "raise"):
                continue
            self._fired.add(i)
            out.append(ev)
        return out

    def silenced(self, worker: int, boundary: int) -> bool:
        """Is ``worker`` inside a heartbeat-silence window?"""
        return any(
            ev.kind == "silence" and ev.worker == worker and ev.in_window(boundary)
            for ev in self.events
        )

    def slow_factor(self, worker: int, boundary: int) -> float:
        """Step-time multiplier for ``worker`` (1.0 = healthy speed)."""
        factor = 1.0
        for ev in self.events:
            if ev.kind == "slow" and ev.worker == worker and ev.in_window(boundary):
                factor = max(factor, ev.factor)
        return factor

    def raising(self, pred: int, func: int, boundary: int) -> bool:
        """Would executing enrichment function (pred, func) raise now?

        The supervisor's breaker calls this both at the onset (the injected
        execution failure) and at each backoff probe — a probe landing past
        a bounded window sees the function recovered.
        """
        return any(
            ev.kind == "raise"
            and ev.pred == pred
            and ev.func == func
            and ev.in_window(boundary)
            for ev in self.events
        )


_WHEN = r"@chunk:(?P<boundary>\d+|auto)(?:\+(?P<duration>\d+))?"
_PATTERNS = {
    "kill": re.compile(r"^kill:w(?P<worker>\d+)" + _WHEN + r"$"),
    "silence": re.compile(r"^silence:w(?P<worker>\d+)" + _WHEN + r"$"),
    "slow": re.compile(
        r"^slow:w(?P<worker>\d+)(?:\*(?P<factor>\d+(?:\.\d+)?))?" + _WHEN + r"$"
    ),
    "raise": re.compile(r"^raise:p(?P<pred>\d+)\.f(?P<func>\d+)" + _WHEN + r"$"),
}


def parse_fault_spec(spec: str, seed: int = 0, horizon: int = 32) -> FaultPlan:
    """Parse the ``--inject-faults`` grammar into a ``FaultPlan``.

    ``auto`` boundaries draw uniformly from ``[1, horizon]`` using ``seed``
    (one deterministic stream for the whole spec, in event order).
    """
    rng = np.random.default_rng(seed)
    events = []
    for tok in spec.split(";"):
        tok = tok.strip()
        if not tok:
            continue
        kind = tok.partition(":")[0]
        pat = _PATTERNS.get(kind)
        m = pat.match(tok) if pat is not None else None
        if m is None:
            raise ValueError(
                f"bad fault event {tok!r}; expected e.g. 'kill:w1@chunk:6', "
                "'silence:w0@chunk:4+3', 'slow:w1*4@chunk:3+8', "
                "'raise:p2.f1@chunk:5+3'"
            )
        g = m.groupdict()
        boundary = (
            int(rng.integers(1, horizon + 1))
            if g["boundary"] == "auto"
            else int(g["boundary"])
        )
        duration = None if g.get("duration") is None else int(g["duration"])
        if kind == "kill" and duration is not None:
            raise ValueError(f"{tok!r}: kill is permanent; drop the +duration")
        events.append(
            FaultEvent(
                kind=kind,
                boundary=boundary,
                worker=int(g["worker"]) if "worker" in g else None,
                pred=int(g["pred"]) if "pred" in g else None,
                func=int(g["func"]) if "func" in g else None,
                duration=duration,
                factor=float(g["factor"]) if g.get("factor") else 4.0,
            )
        )
    return FaultPlan(events, seed=seed)

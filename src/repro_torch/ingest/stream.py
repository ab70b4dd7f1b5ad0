"""Double-buffered host-to-device ingestion feeding a ``PendingRing``.

Port of ``repro.ingest.stream``.  The transfer path:

1. arriving rows are QUANTIZED on the host into one of two preallocated
   staging tensors at the substrate dtype (``copy_`` from the float32 rows:
   round-to-nearest-even, as the reference's numpy cast), pinned when the
   ring lives on the card;
2. the staged rows cross with a non-blocking copy on a side stream, and a
   CUDA event marks the copy's end;
3. the ring write runs on the session's stream after ``wait_event`` on that
   copy (``record_stream`` hands the copied tensor to the session's stream),
   so transfer N overlaps the ring write of batch N-1 and whatever chunks
   the session pipeline has in flight;
4. a staging tensor is reused only after an event recorded after the ring
   write that consumed it has completed (after a shed, the copy's own
   event): with two tensors the host quantizes batch N+1 while the card
   absorbs batch N, and batch N+2 waits for batch N's write.

Throttling (``rate_rows_per_s``) and blocked-ring handling (``on_pressure``
drains, then the push retries with the same device batch) live here, so the
serving loop stays a plain event loop.  On the CPU the same code runs with
no streams: the ring copies the staged rows at once.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core.errors import IngestBackpressure
from repro_torch.ingest.ring import PendingRing


class IngestStream:
    """Micro-batching producer: host rows -> staging -> async H2D -> ring.

    ``on_pressure`` is required for ``policy="block"`` rings under load:
    when a push raises ``IngestBackpressure`` the stream calls it (it drains
    the ring into the session, e.g. ``pipeline.drain_ring``) and retries the
    SAME device batch, so nothing is staged or copied twice.  Without a
    callback the signal propagates to the caller.
    """

    def __init__(
        self,
        ring: PendingRing,
        *,
        batch_rows: Optional[int] = None,
        rate_rows_per_s: Optional[float] = None,
        on_pressure: Optional[Callable[[], object]] = None,
    ):
        self.ring = ring
        self.batch_rows = int(batch_rows or ring.slot_rows)
        if not 1 <= self.batch_rows <= ring.slot_rows:
            raise ValueError(
                f"batch_rows must be in [1, slot_rows={ring.slot_rows}]; got {self.batch_rows}"
            )
        if rate_rows_per_s is not None and rate_rows_per_s <= 0:
            raise ValueError(f"rate_rows_per_s must be > 0, got {rate_rows_per_s}")
        self.rate_rows_per_s = rate_rows_per_s
        self.on_pressure = on_pressure
        self.device = ring.device
        self._cuda = self.device.type == "cuda"
        p, f = ring.session.num_predicates, ring.session.num_functions
        shape = (self.batch_rows, p, f)
        dt = ring.session.substrate_dtype
        self._staging = [torch.empty(shape, dtype=dt, pin_memory=self._cuda) for _ in range(2)]
        # per-buffer reuse gate: an event after the write that consumed it
        self._consumed: list = [None, None]
        self._next = 0
        self._copy_stream = torch.cuda.Stream(self.device) if self._cuda else None
        self._t_next_send = 0.0  # rate-limit horizon (monotonic seconds)
        self.rows_fed = 0
        self.batches_fed = 0
        self.bytes_staged = 0
        self.throttle_waits = 0

    def _stage(self, rows: torch.Tensor) -> tuple:
        """Quantize ``rows`` into the next free staging tensor and start its
        copy -> (buffer index, device batch, copy-done event or None).
        Waits only if the buffer's last consumer is still in flight: the
        double-buffer backstop, not the steady state."""
        i = self._next
        if self._consumed[i] is not None:
            self._consumed[i].synchronize()
            self._consumed[i] = None
        m = rows.shape[0]
        buf = self._staging[i][:m]
        buf.copy_(rows)  # host-side quantization (round to nearest even)
        self._next = 1 - i
        self.bytes_staged += buf.numel() * buf.element_size()
        if not self._cuda:
            return i, buf, None
        with torch.cuda.stream(self._copy_stream):
            dev = buf.to(self.device, non_blocking=True)
            copied = torch.cuda.Event()
            copied.record(self._copy_stream)
        main = torch.cuda.current_stream(self.device)
        main.wait_event(copied)  # the ring write reads the copy
        dev.record_stream(main)
        return i, dev, copied

    def _throttle(self, m: int) -> None:
        if self.rate_rows_per_s is None:
            return
        now = time.monotonic()
        if now < self._t_next_send:
            self.throttle_waits += 1
            time.sleep(self._t_next_send - now)
            now = time.monotonic()
        self._t_next_send = max(self._t_next_send, now) + m / self.rate_rows_per_s

    def feed(self, rows) -> int:
        """Split host ``rows`` [M, P, F] into micro-batches and push each
        through staging -> async copy -> ring.  Returns the rows that LANDED
        (ring or spill queue); under a shed-policy ring the rest went
        overboard and show in ``ring.counters``.  Rows on the card are
        copied to the host first (a host sync)."""
        rows = torch.as_tensor(np.asarray(rows) if not torch.is_tensor(rows) else rows).cpu()
        if rows.ndim != 3:
            raise ValueError(f"feed expects [M, P, F] rows; got {list(rows.shape)}")
        landed = 0
        for off in range(0, rows.shape[0], self.batch_rows):
            chunk = rows[off:off + self.batch_rows]
            self._throttle(chunk.shape[0])
            i, dev, copied = self._stage(chunk)
            while True:
                try:
                    ok = self.ring.push(dev)
                    break
                except IngestBackpressure:
                    if self.on_pressure is None:
                        raise
                    self.on_pressure()  # drain; the retry reuses `dev`
            if self._cuda:
                if ok:  # reuse gate: the ring write that consumed `dev`
                    written = torch.cuda.Event()
                    written.record(torch.cuda.current_stream(self.device))
                    self._consumed[i] = written
                else:  # shed: nothing consumed the copy; gate on the copy itself
                    self._consumed[i] = copied
            if ok:
                landed += chunk.shape[0]
            self.batches_fed += 1
            self.rows_fed += chunk.shape[0]
        return landed

    def counters(self) -> dict:
        """Stream + ring counters in one host-side dict (for reports)."""
        out = dict(self.ring.counters)
        out.update(
            rows_fed=self.rows_fed,
            batches_fed=self.batches_fed,
            throttle_waits=self.throttle_waits,
        )
        return out

"""Streaming ingestion front-end (port of ``repro.ingest``): pinned staging,
non-blocking host-to-device copies on a side stream, and the pending-row ring
that ``SessionPipeline.drain_ring`` drains; ``IngestBackpressure`` (from
``core.errors``) is the typed signal when enrichment falls behind arrivals."""

from repro_torch.core.errors import IngestBackpressure
from repro_torch.ingest.ring import PendingRing
from repro_torch.ingest.stream import IngestStream

__all__ = ["IngestBackpressure", "IngestStream", "PendingRing"]

"""Data pipelines: synthetic LM token streams with host-side prefetch onto
the device, and the PIQUE object partition (port of
``repro.data.pipeline``).

Training data is synthetic and deterministic per step, made on the host
with numpy's generator exactly as the reference makes it, so a batch is
bitwise the reference's.  ``PrefetchIterator`` overlaps making the next
batches with the device's work: a background thread copies each batch
from pinned memory to the card on a side stream and records an event,
and the consumer's stream waits on that event (and the tensors are marked
as used by it, so the caching allocator does not hand their memory back
to the side stream early) before it reads the batch.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass
class TokenStreamConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0


class SyntheticTokenStream:
    """Deterministic synthetic LM batches: order-1 token chains with noise,
    so the loss is learnable (a smoke run descends)."""

    def __init__(self, cfg: TokenStreamConfig, extra_fn: Optional[Callable] = None):
        self.cfg = cfg
        self.extra_fn = extra_fn  # adds modality fields (frames / image_embeds)

    def batch(self, step: int) -> dict:
        """-> {"tokens", "targets"} int32 [B, S] numpy arrays (+ the extras)."""
        cfg = self.cfg
        rng = np.random.default_rng(cfg.seed + step)
        b, s = cfg.global_batch, cfg.seq_len
        # order-1 structure: next token = (token + drift) % V, with noise
        start = rng.integers(0, cfg.vocab_size, size=(b, 1))
        drift = rng.integers(1, 7, size=(b, 1))
        idx = np.arange(s)[None, :]
        toks = (start + drift * idx) % cfg.vocab_size
        noise = rng.integers(0, cfg.vocab_size, size=(b, s))
        keep = rng.uniform(size=(b, s)) < 0.9
        toks = np.where(keep, toks, noise).astype(np.int32)
        batch = {"tokens": toks, "targets": np.roll(toks, -1, axis=1).astype(np.int32)}
        if self.extra_fn is not None:
            batch.update(self.extra_fn(rng, b))
        return batch

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


def to_device(batch: dict, device) -> dict:
    """A numpy batch -> tensors on ``device`` (synchronous)."""
    return {k: torch.from_numpy(np.asarray(v)).to(device) for k, v in batch.items()}


class PrefetchIterator:
    """Batches from ``it`` placed on ``device`` (None means the card) by a
    background thread, up to ``depth`` ahead.  On the card each batch is
    copied from pinned memory on a side stream; ``__next__`` makes the
    current stream wait for that copy.  An exception in the worker is raised
    by ``__next__``.

    ``shardings`` (with ``mesh``): a dict of DTensor placements per batch
    key (``launch.steps.input_placements``); each batch then becomes
    DTensors in them, every rank keeping its own shard of the batch it
    drew (``sharding.place_whole``: no collective, so the thread may run
    it beside the step's collectives)."""

    def __init__(self, it: Iterator[dict], device=None, depth: int = 2, shardings=None,
                 mesh=None):
        if (shardings is None) != (mesh is None):
            raise ValueError("PrefetchIterator takes shardings and mesh together")
        self.it = iter(it)
        self.shardings, self.mesh = shardings, mesh
        self.device = resolve_device(device)
        self.stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._worker, daemon=True)
        self.thread.start()

    def _place(self, batch: dict):
        if self.shardings is not None:
            from repro_torch.models.sharding import place_whole

            return {k: place_whole(torch.from_numpy(np.asarray(v)), self.mesh, self.shardings[k])
                    for k, v in batch.items()}, None
        if self.stream is None:
            return to_device(batch, self.device), None
        with torch.cuda.stream(self.stream):
            out = {k: torch.from_numpy(np.asarray(v)).pin_memory().to(self.device,
                                                                     non_blocking=True)
                   for k, v in batch.items()}
            ready = torch.cuda.Event()
            ready.record(self.stream)
        return out, ready

    def _worker(self):
        try:
            for batch in self.it:
                if self._stop.is_set():
                    return
                self.q.put(("batch", self._place(batch)))
        except Exception as exc:  # handed to the consumer, which raises it
            self.q.put(("error", exc))
            return
        self.q.put(("end", None))

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        kind, item = self.q.get()
        if kind == "end":
            raise StopIteration
        if kind == "error":
            raise item
        batch, ready = item
        if ready is not None:
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(ready)
            for t in batch.values():
                t.record_stream(consumer)
        return batch

    def close(self, timeout: float = 10.0) -> None:
        """Stop the worker: drain what it queued so a blocked put returns."""
        self._stop.set()
        while self.thread.is_alive():
            try:
                self.q.get(timeout=0.1)
            except queue.Empty:
                pass
            self.thread.join(timeout=0.1)
            timeout -= 0.1
            if timeout <= 0:
                raise TimeoutError("the prefetch worker did not stop")


def shard_object_ranges(num_objects: int, num_shards: int) -> list[tuple[int, int]]:
    """Even [start, end) object partition per shard (PIQUE serving layout)."""
    base = num_objects // num_shards
    rem = num_objects % num_shards
    out = []
    start = 0
    for i in range(num_shards):
        size = base + (1 if i < rem else 0)
        out.append((start, start + size))
        start += size
    return out

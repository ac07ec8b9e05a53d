"""Training data pipeline of the model zoo (the JAX package's
``data/pipeline.py``).

- ``TokenStream``: deterministic synthetic LM token batches, the
  reference's numpy draw (the same seed yields the same arrays).
- ``DeviceLoader``: the one-card loader.  A background thread draws host
  batches and copies them to the card from pinned memory on a side
  stream; the consumer's stream waits on the copy's event before it
  reads a batch.
- ``ShardedLoader``: the reference's, over a mesh.  The same thread
  places each batch with the plan's input placements as DTensors (every
  rank draws the same batch and keeps its own chunk; nothing is sent).
- Fault tolerance: a corrupt or failed batch read is skipped and counted
  in ``skipped``, never fatal; a placement error is raised in the
  consumer.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass
class TokenStream:
    """Synthetic LM token stream: infinite, seeded, shape-stable."""
    vocab_size: int
    batch: int
    seq_len: int
    seed: int = 0

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        rng = np.random.default_rng(self.seed)
        while True:
            toks = rng.integers(0, self.vocab_size,
                                (self.batch, self.seq_len + 1), dtype=np.int32)
            yield {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


class DeviceLoader:
    """Prefetching host -> device loader (the JAX package's
    ``ShardedLoader`` on one card; ``device`` in place of its shardings).

    Up to ``prefetch`` batches are placed ahead of the consumer.  On a
    CUDA device each array is pinned and copied with ``non_blocking=True``
    on a side stream; ``__next__`` makes the current stream wait on that
    copy's event and ``record_stream``s each tensor, so the step never
    reads a half-copied batch and the allocator never hands the memory
    back to the copy stream while the step reads it.  ``close()`` stops
    the thread (also on ``with``)."""

    def __init__(self, it: Iterator[Dict[str, np.ndarray]],
                 device: DeviceLike = None, prefetch: int = 2):
        self.device = resolve_device(device)
        self._it = iter(it)
        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()
        self._stream = torch.cuda.Stream(self.device) \
            if self.device.type == "cuda" else None
        self.skipped = 0
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _shard(self, batch: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        """The placed batch as the consumer gets it (here: as it is)."""
        return batch

    @staticmethod
    def _local(t) -> torch.Tensor:
        return t

    def _place(self, batch: Dict[str, Any]):
        if self._stream is None:
            return self._shard({k: torch.from_numpy(np.ascontiguousarray(
                v)).to(self.device) for k, v in batch.items()}), None
        with torch.cuda.stream(self._stream):
            dev = self._shard({
                k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                .to(self.device, non_blocking=True)
                for k, v in batch.items()})
            done = torch.cuda.Event()
            done.record(self._stream)
        return dev, done

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self):
        while not self._stop.is_set():
            try:
                batch = next(self._it)
            except StopIteration:
                self._put(None)
                return
            except Exception:           # corrupt batch: skip, keep streaming
                self.skipped += 1
                continue
            try:
                item = self._place(batch)
            except BaseException as e:   # raised in the consumer
                self._err = e
                self._put(None)
                return
            if not self._put(item):
                return

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, torch.Tensor]:
        item = self._q.get()
        if item is None:
            self._q.put(None)            # every later call ends too
            if self._err is not None:
                raise self._err
            raise StopIteration
        batch, done = item
        if done is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(done)
            for t in batch.values():
                self._local(t).record_stream(cur)
        return batch

    def close(self):
        """Stop the prefetch thread and drop the batches it placed."""
        self._stop.set()
        self._thread.join(timeout=10)
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                return

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class ShardedLoader(DeviceLoader):
    """Prefetching host -> mesh loader (the JAX package's
    ``ShardedLoader``).

    ``shardings`` maps each batch key to its spec on ``mesh`` (a
    ``ShardPlan``'s ``input_shardings``); the prefetch thread copies each
    batch to the mesh's device type (the current card on CUDA, as
    ``DeviceLoader`` does) and places it as DTensors by those specs
    (``sharding.distribute``: every rank draws the same batch and keeps
    its own chunk).  A corrupt batch is skipped and counted in
    ``skipped``; a placement error, such as a key without a spec, is
    raised in the consumer."""

    def __init__(self, it: Iterator[Dict[str, np.ndarray]], shardings: Any,
                 mesh, prefetch: int = 2):
        self.mesh, self.shardings = mesh, shardings
        dev = mesh.device_type
        if dev == "cuda":
            dev = torch.device("cuda", torch.cuda.current_device())
        super().__init__(it, dev, prefetch)

    def _shard(self, batch: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        from repro_torch.distributed import sharding as SH
        return {k: SH.distribute(v, self.mesh, self.shardings[k])
                for k, v in batch.items()}

    @staticmethod
    def _local(t) -> torch.Tensor:
        return t.to_local()

"""PipelinedExecutor — the chunk pipeline's measured overlap engine.

A streaming fit overlaps host and device only if the host work for chunk
t+1 (parse, pad, the host-to-device copy's enqueue) runs while the device
executes step t. This module makes that overlap a measured property:

* a bounded daemon-thread producer runs ``prep`` over the item stream and
  hands results through a ``depth``-bounded queue (depth 2 = double
  buffering: one chunk in use, one staged);
* the producer's busy time (``prep_s``) and the consumer's blocked time
  (``wait_s``) are accumulated; their ratio is the overlap efficiency:

      overlap_pct = 100 * max(0, 1 - wait_s / prep_s)

  100% means every second of host prep was hidden behind the consumer's
  work; 0% means the pipeline degenerated to serial. The wait for the first
  item counts against overlap — that prep is genuinely exposed.

Results are yielded in order; a producer exception re-raises at the
consuming ``next()``; closing the generator early stops the worker. The
native parser and the pinned-memory copies release the GIL, so the worker
overlaps the consumer even on one core.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Callable, Iterator

_EOF = object()


@dataclasses.dataclass
class PipelineStats:
    """Counters for one pipelined stream (final once ``done`` is True)."""

    items: int = 0        # results yielded to the consumer
    prep_s: float = 0.0   # producer time pulling items and inside prep
    wait_s: float = 0.0   # consumer time blocked waiting on the queue
    wall_s: float = 0.0   # consumer wall from first wait to stream end
    retries: int = 0      # transient source-read retries (resilience/retry.py)
    done: bool = False

    @property
    def overlap_pct(self) -> float:
        """Share of producer time hidden behind consumer work, 0-100."""
        if self.prep_s <= 0.0:
            return 0.0
        return 100.0 * min(max(1.0 - self.wait_s / self.prep_s, 0.0), 1.0)

    def merge(self, other: "PipelineStats") -> "PipelineStats":
        """Fold another stream's counters in (a fit with several streams
        reports one fit-level overlap)."""
        self.items += other.items
        self.prep_s += other.prep_s
        self.wait_s += other.wait_s
        self.wall_s += other.wall_s
        self.retries += other.retries
        return self


class PipelinedExecutor:
    """Bounded background-thread prefetch with measured overlap.

    ``prep(item)`` runs on the worker thread. ``depth`` bounds how far the
    producer runs ahead (double buffering at the default 2); ``depth=0``
    still prefetches with a queue of one. Counters land on ``self.stats``.
    """

    def __init__(self, prep: Callable, *, depth: int = 2,
                 name: str = "chunk-prefetch"):
        self.prep = prep
        self.depth = max(1, depth)
        self.name = name
        self.stats = PipelineStats()

    def run(self, items: Iterator) -> Iterator:
        """Yield ``prep(item)`` for every item, in order, prefetched."""
        stats = self.stats
        q: queue.Queue = queue.Queue(maxsize=self.depth)
        stop = threading.Event()
        t = threading.Thread(
            target=self._produce, args=(iter(items), q, stop, self.prep, stats),
            daemon=True, name=self.name)
        t.start()
        t_start = time.perf_counter()
        try:
            while True:
                t0 = time.perf_counter()
                got = q.get()
                stats.wait_s += time.perf_counter() - t0
                if (isinstance(got, tuple) and len(got) == 2
                        and got[0] is _EOF):
                    if got[1] is not None:
                        raise got[1]
                    return
                stats.items += 1
                yield got
        finally:
            stop.set()
            stats.wall_s = time.perf_counter() - t_start
            stats.done = True

    @staticmethod
    def _produce(it, q, stop, prep, stats) -> None:
        """The worker-thread body."""
        try:
            while True:
                # time the pull too: the upstream iterator is where the
                # parse lives, and it runs on this thread
                t0 = time.perf_counter()
                try:
                    item = next(it)
                except StopIteration:
                    break
                out = prep(item)
                stats.prep_s += time.perf_counter() - t0
                while not stop.is_set():
                    try:
                        q.put(out, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
            payload = (_EOF, None)
        except BaseException as e:  # noqa: BLE001 - re-raised on the consumer
            payload = (_EOF, e)
        while not stop.is_set():
            try:
                q.put(payload, timeout=0.1)
                return
            except queue.Full:
                continue


def prefetch_iter(prep: Callable, items: Iterator, *, depth: int = 2,
                  stats_into: PipelineStats | None = None) -> Iterator:
    """One-shot functional form: run ``items`` through a fresh
    ``PipelinedExecutor``; ``stats_into`` receives the stream's counters
    (merged) when it ends."""
    ex = PipelinedExecutor(prep, depth=depth)
    try:
        yield from ex.run(items)
    finally:
        if stats_into is not None:
            stats_into.merge(ex.stats)

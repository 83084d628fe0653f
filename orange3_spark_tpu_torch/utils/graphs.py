"""How this package captures a CUDA graph: one recipe for the fit's replay
(``models/hashed_linear._Replay``) and the serving path's bucket programs
(``serve/context._BucketGraph``).

The recipe: under one process-wide lock, run the warm-up once on a side
stream (library handles, workspaces), wait for it, then capture in
thread-local mode (``capture_error_mode="thread_local"``), so another
thread may keep copying or replaying while a capture runs, and tick the
capture count (``utils.profiling.count_graph_capture``) inside the lock.
"""

from __future__ import annotations

import gc
import threading
import time
from collections import OrderedDict
from typing import Any, Callable

import numpy as np
import torch

from orange3_spark_tpu_torch.utils.profiling import count_graph_capture

# one capture at a time in this process (a serving warm-up captures the
# ladder before traffic; a late first touch captures beside live replays)
_CAPTURE_LOCK = threading.Lock()


def capture_graph(fn: Callable[[], Any], device: torch.device,
                  warm: Callable[[], Any] | None = None
                  ) -> tuple[torch.cuda.CUDAGraph, Any, int]:
    """Capture ``fn()`` on ``device`` into a CUDA graph, after running
    ``warm()`` (default ``fn()``) once on a side stream.

    Returns the graph, what ``fn`` returned while captured (the graph's
    static outputs) and the bytes the graph's memory pool reserved. The
    device sync, ``gc.collect()`` and ``empty_cache()`` that
    ``torch.cuda.graph`` runs on entry run first here, so the reserved
    bytes read before and after differ by the pool alone. A failed
    capture raises; nothing falls back to eager execution."""
    with _CAPTURE_LOCK:
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            (warm or fn)()
        torch.cuda.current_stream(device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        torch.cuda.synchronize(device)
        gc.collect()
        torch.cuda.empty_cache()
        pool0 = torch.cuda.memory_reserved(device)
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            out = fn()
        pool_bytes = torch.cuda.memory_reserved(device) - pool0
        count_graph_capture()
    return graph, out, pool_bytes


class EpochReplay:
    """A fit's replay of whole epochs: ``graph`` (one captured epoch, or
    None) and ``_epoch()`` (the same steps, run eagerly) are the
    subclass's. ``run(n)`` replays the graph ``n`` times, or runs the
    steps ``n`` times where nothing was captured (the CPU: the host does
    the device's work, so its seconds feed the live fit's goodput as
    device compute). Each timed replay lies between a pair of CUDA events;
    ``device_seconds()`` reads the device's own time in them, so the
    host's time inside ``graph.replay()`` (waiting for room in the launch
    queue) and the device's idle gaps between replays stay out of it."""

    def __init__(self):
        self.graph: torch.cuda.CUDAGraph | None = None
        self._events: list = []

    def _epoch(self) -> None:
        raise NotImplementedError

    def run(self, n_epochs: int, *, timed: bool = True) -> None:
        """Run ``n_epochs`` epochs; ``timed=False`` records no events (a
        caller whose own waits feed the goodput)."""
        from orange3_spark_tpu_torch.obs import prof

        if self.graph is None:
            t0 = time.perf_counter()
            for _ in range(n_epochs):
                self._epoch()
            prof.note_sync(time.perf_counter() - t0)
            return
        for _ in range(n_epochs):
            if timed:
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
            self.graph.replay()
            if timed:
                end.record()
                self._events.append((start, end))

    def device_seconds(self) -> float:
        """The device's seconds in the timed replays since the last call
        (it waits for the last of them to end), then forgets them."""
        events, self._events = self._events, []
        if not events:
            return 0.0
        events[-1][1].synchronize()
        return sum(a.elapsed_time(b) for a, b in events) / 1e3


# device copies of small host constants (column indices, split points),
# made once outside any capture and read in place by every later call
_CONSTS: "OrderedDict[tuple, torch.Tensor]" = OrderedDict()
_CONSTS_LOCK = threading.Lock()
_CONSTS_MAX = 4096


def device_constant(values, dtype: torch.dtype, device) -> torch.Tensor:
    """A device tensor of the host ``values`` (a sequence or numpy array),
    made once per (values, dtype, device) and kept. Copying host data to
    the card waits for the copy, which a CUDA graph capture cannot do; a
    capture's warm-up run (``capture_graph``) makes the constant first,
    and the captured run then reads it where it lies. Nothing may write to
    the result."""
    arr = np.asarray(values)
    device = torch.device(device)
    key = (arr.dtype.str, arr.shape, arr.tobytes(), str(dtype), str(device))
    with _CONSTS_LOCK:
        t = _CONSTS.get(key)
        if t is not None:
            _CONSTS.move_to_end(key)
            return t
    t = torch.as_tensor(np.ascontiguousarray(arr)).to(dtype=dtype, device=device)
    with _CONSTS_LOCK:
        _CONSTS[key] = t
        while len(_CONSTS) > _CONSTS_MAX:
            _CONSTS.popitem(last=False)
    return t

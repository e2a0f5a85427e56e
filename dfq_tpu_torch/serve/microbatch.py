"""Deadline micro-batching in front of the int8 engine (port of
``dfq_tpu/serve/microbatch.py``, which is framework-neutral).

A batched forward costs far less per image than one image at a time, so
the server accumulates requests toward its largest batch bucket under a
latency budget and dispatches partial batches on deadline, padded up to
the nearest bucket.

Design:
- ``MicroBatcher(forward_fn, buckets, max_wait_ms)``: ``forward_fn``
  maps a stacked request batch (first axis = bucket size) to per-item
  results; it is run once per bucket size up front (warm-up) so the
  first request of a size pays no first-call cost.
- ``submit(item) -> Future``: enqueue one request.
- A dispatcher thread batches the queue: dispatch when the queue can
  fill the largest bucket, or when the OLDEST request has waited
  ``max_wait_ms`` (then pick the smallest bucket >= queue length and
  zero-pad). In-flight dispatches overlap via a small worker pool
  (``pipeline_depth``), so device compute and result fetches pipeline.

Thread-safety: submit() may be called from many threads. Results are
delivered through ``concurrent.futures.Future``.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch


@dataclasses.dataclass
class MicroBatchStats:
    """Aggregate serving statistics (see ``snapshot``)."""

    dispatches: int = 0
    items: int = 0
    padded: int = 0
    dispatch_sizes: Optional[dict] = None
    latencies_ms: Optional[list] = None

    def percentile(self, p: float) -> float:
        if not self.latencies_ms:
            return 0.0
        xs = sorted(self.latencies_ms)
        i = min(len(xs) - 1, int(p / 100.0 * len(xs)))
        return xs[i]


class MicroBatcher:
    def __init__(
        self,
        forward_fn: Callable,
        example_item,
        buckets: Sequence[int] = (8, 32, 128),
        max_wait_ms: float = 3.0,
        pipeline_depth: int = 2,
        stack_fn: Optional[Callable] = None,
        warmup: bool = True,
    ):
        """``forward_fn(batch)``: stacked items -> per-item results
        (first axis preserved). ``example_item``: one request payload
        (used to warm every bucket). ``stack_fn(items)``:
        optional custom batch assembly (default ``np.stack``)."""
        import numpy as np

        self._np = np
        self.forward_fn = forward_fn
        self.buckets = sorted(set(int(b) for b in buckets))
        self.max_wait = max_wait_ms / 1e3
        self.stack_fn = stack_fn or (lambda items: np.stack(items, 0))
        self._lock = threading.Condition()
        self._queue: List[Tuple[Any, Future, float]] = []
        self._stats = MicroBatchStats(dispatch_sizes={}, latencies_ms=[])
        self._stop = False
        self._pool = ThreadPoolExecutor(max_workers=max(1, pipeline_depth))
        self._inflight = threading.Semaphore(max(1, pipeline_depth))
        if warmup:
            for b in self.buckets:
                batch = self.stack_fn([example_item] * b)
                _ = forward_fn(batch)  # warm-up; result discarded
        self._thread = threading.Thread(target=self._dispatch_loop, daemon=True)
        self._thread.start()

    # ------------------------------------------------------------------
    def submit(self, item) -> Future:
        fut: Future = Future()
        with self._lock:
            if self._stop:
                raise RuntimeError("MicroBatcher is stopped")
            self._queue.append((item, fut, time.perf_counter()))
            self._lock.notify()
        return fut

    def stop(self, drain: bool = True):
        with self._lock:
            self._stop = True
            self._lock.notify()
        self._thread.join()
        if drain:
            self._pool.shutdown(wait=True)

    def stats(self) -> MicroBatchStats:
        with self._lock:
            return dataclasses.replace(
                self._stats,
                dispatch_sizes=dict(self._stats.dispatch_sizes),
                latencies_ms=list(self._stats.latencies_ms),
            )

    # ------------------------------------------------------------------
    def _pick_bucket(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        return self.buckets[-1]

    def _dispatch_loop(self):
        bmax = self.buckets[-1]
        while True:
            with self._lock:
                while not self._stop and not self._ready_locked(bmax):
                    timeout = None
                    if self._queue:
                        age = time.perf_counter() - self._queue[0][2]
                        timeout = max(self.max_wait - age, 0.0)
                    self._lock.wait(timeout=timeout)
                if not self._queue:
                    if self._stop:
                        return
                    continue
                n = min(len(self._queue), bmax)
                batch_items = self._queue[:n]
                del self._queue[:n]
            self._inflight.acquire()
            self._pool.submit(self._run_batch, batch_items)

    def _ready_locked(self, bmax: int) -> bool:
        if len(self._queue) >= bmax:
            return True
        if self._queue:
            return (time.perf_counter() - self._queue[0][2]) >= self.max_wait
        return False

    def _run_batch(self, batch_items):
        try:
            np = self._np
            n = len(batch_items)
            bucket = self._pick_bucket(n)
            items = [it for it, _, _ in batch_items]
            if bucket > n:
                items = items + [items[0]] * (bucket - n)  # pad rows
            batch = self.stack_fn(items)
            out = self.forward_fn(batch)
            if isinstance(out, torch.Tensor):
                out = out.cpu()  # device fetch (and sync) happens here
            out = np.asarray(out)
            now = time.perf_counter()
            for i, (_, fut, t0) in enumerate(batch_items):
                fut.set_result(out[i])
            with self._lock:
                st = self._stats
                st.dispatches += 1
                st.items += n
                st.padded += bucket - n
                st.dispatch_sizes[bucket] = st.dispatch_sizes.get(bucket, 0) + 1
                st.latencies_ms.extend(
                    (now - t0) * 1e3 for _, _, t0 in batch_items
                )
        except Exception as e:  # deliver failures, never hang callers
            for _, fut, _ in batch_items:
                if not fut.done():
                    fut.set_exception(e)
        finally:
            self._inflight.release()

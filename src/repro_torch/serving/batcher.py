"""Dynamic micro-batching: ragged request streams -> static shape buckets
(counterpart of ``repro.serving.batcher``).

The fused engine pipeline (``SearchEngine.search_jit``) captures one CUDA
graph per distinct query-batch shape. A serving workload is ragged — one
request here, 40 there — so feeding raw arrival sizes to the engine would
capture constantly. The ``Batcher`` absorbs the raggedness:

  - requests queue up (thread-safe, FIFO);
  - a dispatcher pulls the oldest request's ``k``-group, waiting up to
    ``max_wait_s`` for the batch to fill (classic latency/throughput knob);
  - the group is padded with zero queries up to the smallest **shape
    bucket** that fits (default Q in (1, 8, 32, 128)).

Only bucket shapes ever reach the engine, so steady-state serving captures
at most once per (bucket, k) and padding rows are sliced away before any
caller sees results (tested: padded queries cannot leak).

Requests with different ``k`` never share a batch — ``k`` is a static shape
knob of the fused pipeline. Mixed-``k`` streams simply form per-``k`` groups.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from concurrent.futures import Future

import numpy as np

from repro_torch.serving.errors import DeadlineExceeded, LoopClosed, Overloaded

DEFAULT_BUCKETS = (1, 8, 32, 128)


def bucket_for(n: int, buckets: tuple[int, ...] = DEFAULT_BUCKETS) -> int:
    """Smallest bucket >= n. n must not exceed the largest bucket."""
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"batch of {n} exceeds largest bucket {buckets[-1]}")


def pad_to_bucket(queries: np.ndarray, bucket: int) -> np.ndarray:
    """(n, D) -> (bucket, D) f32, zero rows past n (n <= bucket).

    Zero rows are *real* queries as far as the kernel is concerned — they
    cost work but their results are never surfaced; correctness never
    depends on the pad content.
    """
    n, d = queries.shape
    if n > bucket:
        raise ValueError(f"{n} queries do not fit bucket {bucket}")
    out = np.zeros((bucket, d), np.float32)
    out[:n] = queries
    return out


@dataclasses.dataclass
class Request:
    """One queued search request."""

    query: np.ndarray   # (D,) f32
    k: int
    tenant: str
    future: Future
    t_submit: float     # time.monotonic() at enqueue
    namespace: int = -1  # engine namespace id, -1 = unrestricted; namespaces
    #                      are traced per-row, so mixed-namespace batches
    #                      share one dispatch (docs/filtering.md)
    deadline: float | None = None  # absolute time.monotonic() past which the
    #                      request is failed instead of dispatched; None =
    #                      wait forever (docs/serving.md)


class Batcher:
    """Thread-safe request queue + shape-bucket batch former.

    ``submit`` is called from any number of caller threads; ``next_batch``
    from the single serving-loop thread. ``max_wait_s`` bounds how long the
    oldest pending request waits for co-riders: 0 dispatches immediately
    (latency-optimal), larger values trade queueing delay for occupancy.
    """

    def __init__(self, buckets: tuple[int, ...] = DEFAULT_BUCKETS,
                 max_wait_s: float = 0.002, max_pending: int | None = None):
        if not buckets or list(buckets) != sorted(set(buckets)):
            raise ValueError(f"buckets must be ascending and unique: {buckets}")
        if buckets[0] < 1:
            raise ValueError(f"buckets must be >= 1: {buckets}")
        if max_pending is not None and max_pending < 1:
            raise ValueError(f"max_pending must be >= 1, got {max_pending}")
        self.buckets = tuple(int(b) for b in buckets)
        self.max_wait_s = float(max_wait_s)
        # bounded admission (docs/serving.md): beyond this many queued
        # requests, submit sheds load with a typed Overloaded instead of
        # letting the queue (and every caller's latency) grow without limit.
        # None = unbounded, the pre-hardening behavior.
        self.max_pending = None if max_pending is None else int(max_pending)
        self._queue: deque[Request] = deque()
        self._cond = threading.Condition()
        self._closed = False
        self.rejects = 0          # submits shed by the max_pending bound
        self.deadline_misses = 0  # queued requests failed past their deadline

    # -- producer side ------------------------------------------------------

    def submit(self, query, k: int = 10, tenant: str = "default",
               namespace: int = -1, deadline_s: float | None = None) -> Future:
        """Enqueue one query; the future resolves to a ``loop.ServeResult``.

        ``deadline_s`` (relative seconds) bounds the total queue wait: a
        request still undispatched past it is failed with
        ``DeadlineExceeded`` before it can burn a batch slot. Raises
        ``Overloaded`` immediately when the queue is at ``max_pending``.
        """
        q = np.asarray(query, np.float32)
        if q.ndim != 1:
            raise ValueError(f"submit takes a single (D,) query, got {q.shape}")
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        if deadline_s is not None and deadline_s <= 0:
            raise ValueError(f"deadline_s must be > 0, got {deadline_s}")
        now = time.monotonic()
        req = Request(query=q, k=int(k), tenant=str(tenant), future=Future(),
                      t_submit=now, namespace=int(namespace),
                      deadline=None if deadline_s is None else now + deadline_s)
        with self._cond:
            if self._closed:
                raise LoopClosed("batcher is closed")
            if (self.max_pending is not None
                    and len(self._queue) >= self.max_pending):
                self.rejects += 1
                raise Overloaded(
                    f"queue at max_pending={self.max_pending}; request shed")
            self._queue.append(req)
            self._cond.notify_all()
        return req.future

    def close(self) -> None:
        """Reject further submits; pending requests can still be drained."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def reopen(self) -> None:
        """Accept submits again after ``close`` (loop restart)."""
        with self._cond:
            self._closed = False

    def pending(self) -> int:
        with self._cond:
            return len(self._queue)

    # -- consumer side (serving loop thread) --------------------------------

    def next_batch(self, timeout: float | None = None) -> list[Request] | None:
        """Dequeue the next dispatchable batch, or None on timeout.

        Picks the oldest request, waits up to ``max_wait_s`` (measured from
        that request's submit time) for more same-``k`` requests, then
        returns up to ``max(buckets)`` of them in FIFO order. Different-``k``
        requests stay queued and head the next batch.
        """
        cap = self.buckets[-1]
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while True:
                self._purge_expired_locked()
                if self._queue:
                    break
                if self._closed:
                    return None
                wait = None if deadline is None else deadline - time.monotonic()
                if wait is not None and wait <= 0:
                    return None
                self._cond.wait(wait)

            head = self._queue[0]
            batch_deadline = head.t_submit + self.max_wait_s
            while (self._count_k(head.k) < cap
                   and not self._closed
                   and (remaining := batch_deadline - time.monotonic()) > 0):
                self._cond.wait(remaining)

            # expire again after the co-rider wait: a request whose deadline
            # passed while the batch was filling must not occupy a slot (it
            # would reach search_jit only to have its result thrown away)
            self._purge_expired_locked()
            if not self._queue:
                return None
            head = self._queue[0]
            out: list[Request] = []
            kept: deque[Request] = deque()
            for req in self._queue:
                if req.k == head.k and len(out) < cap:
                    out.append(req)
                else:
                    kept.append(req)
            self._queue = kept
            return out

    def _purge_expired_locked(self) -> None:
        """Fail every queued request past its deadline (caller holds _cond)."""
        now = time.monotonic()
        if not any(r.deadline is not None and r.deadline < now
                   for r in self._queue):
            return
        kept: deque[Request] = deque()
        for req in self._queue:
            if req.deadline is not None and req.deadline < now:
                self.deadline_misses += 1
                if not req.future.done():
                    req.future.set_exception(DeadlineExceeded(
                        f"deadline expired after "
                        f"{now - req.t_submit:.3f}s in queue"))
            else:
                kept.append(req)
        self._queue = kept

    def _count_k(self, k: int) -> int:
        return sum(1 for r in self._queue if r.k == k)

    # -- batch forming -------------------------------------------------------

    def form(self, requests: list[Request]) -> tuple[np.ndarray, int]:
        """Stack + pad a batch: -> ((bucket, D) f32 queries, bucket)."""
        q = np.stack([r.query for r in requests])
        bucket = bucket_for(q.shape[0], self.buckets)
        return pad_to_bucket(q, bucket), bucket

"""CUDA-graph cache behind ``SearchEngine.search_jit`` (counterpart of the
reference's ``_fused_pipeline``, the one ``jax.jit`` of the whole query
path, and of its ``fused_cache_size``).

The reference compiles the pipeline once per (static knobs, input shapes,
presence of each optional input) and dispatches each batch as one program.
Here the eager pipeline is captured once per such key into a
``torch.cuda.CUDAGraph`` and replayed, so a batch costs one graph launch
instead of one host dispatch per device op.

- **Key** (``graph_key``): the query shape; k, nprobe, r, the config's
  scan_impl, rerank_impl, probe_policy, early_exit and ef, and the coarse
  quantizer's kind; the shape of each
  optional input (filter bits, namespaces, margin tau, and the engine's
  live-row bitmap, present while its store holds tombstones), None where
  it is absent; and the identity (``data_ptr``, shape) of every engine
  tensor the graph reads, the coarse quantizer's included. Never the values of the queries, filter,
  namespaces or tau: those are copied into the graph's static input
  buffers before each replay, so new values at a seen key capture
  nothing; nor the values of the engine's tensors, which a replay reads.
- **First call of a key.** The pipeline runs eagerly once on the cache's
  capture stream. That resolves every autotune verdict the key needs (the
  scan sweep, a gathered verdict's second resolve at probe_fill 1.0, the
  re-rank sweep) and warms cuBLAS and the allocator on that stream; then
  the pipeline is captured and replayed. A verdict is fixed at capture, as
  the reference's jit fixes it at trace time: clearing or reloading the
  autotune table later leaves a captured graph as it was. A verdict still
  unresolved at capture raises (``kernels.ops``), and any failed capture
  propagates its error: there is no eager fallback.
- **Later calls** copy the inputs in, replay on the current stream and
  return clones of the outputs, so a caller's result never changes under a
  later replay. One lock per engine covers copy-in, replay and copy-out,
  and an event orders them on the card when callers use several streams.
  The engine's eager searches and its writes take the same lock and event
  (``ordered``), so no search sees a half-written epoch and no write lands
  under a search still in flight on another stream.
- **State.** A graph bakes in the addresses of the engine's tensors; it
  reads their values at each replay. The engine's shape-keeping mutations
  (delete, an upsert into spare slots, compaction at the same cap) write
  into those tensors in place, inside ``ordered``, so the graphs keep
  serving the new epoch. A mutation that must reallocate (the engine's
  first write, which clones the tensors it was given; another cap; a
  larger base) drops the engine's graphs at once (``clear``), inside the
  same ``ordered`` block that installs the new tensors. When the
  identity changes otherwise (a caller replaced ``engine.index``, ``base``
  or ``ns_member``), the cache drops every graph before it captures anew;
  it holds the state tensors its graphs read, so their memory cannot be
  reused under a graph.
- **Memory.** The graphs of one engine share one memory pool. That is
  safe because the lock and the event serialise every copy-in, replay and
  copy-out of the engine: one graph's intermediates may overlap another's
  outputs, but outputs are cloned right after their own replay, before any
  other replay of the engine starts.
- **Launch counts.** A replay does not call the kernels' wrappers, so
  their ``launches`` counters would not see it. The launches a capture
  records are taken back out of the counters, and every replay adds them,
  so a counter counts the kernels the card ran, whichever way they were
  issued.
"""
from __future__ import annotations

import contextlib
import threading
import time
import weakref
from typing import Callable, NamedTuple

import torch

from repro_torch.kernels import ops

# every live engine's cache, for fused_cache_size
_CACHES: weakref.WeakSet = weakref.WeakSet()


def fused_cache_size() -> int:
    """Graphs held across every live engine in the process: at most one
    per (shape, knobs, presence, state) key an engine has served. It falls
    when an engine drops its graphs; ``GraphCache.captures`` only grows."""
    return sum(len(cache) for cache in list(_CACHES))


def state_identity(tensors) -> tuple:
    """(data_ptr, shape) of each tensor a graph reads; None stays None."""
    return tuple(None if t is None else (t.data_ptr(), tuple(t.shape))
                 for t in tensors)


def graph_key(q: torch.Tensor, optional, *, knobs: tuple,
              state: tuple) -> tuple:
    """The cache key of one request: ``q``'s shape, the static ``knobs``,
    the shape of each ``optional`` input (None = absent) and the engine's
    ``state_identity``. No input's values enter it."""
    return (tuple(q.shape), tuple(knobs),
            tuple(None if t is None else tuple(t.shape) for t in optional),
            state)


def _clone(out):
    """Fresh copies of a (nested) named tuple of tensors."""
    if isinstance(out, torch.Tensor):
        return out.clone()
    return type(out)(*(_clone(x) for x in out))


class _Entry(NamedTuple):
    graph: object         # torch.cuda.CUDAGraph
    inputs: tuple         # static input buffers, None where absent
    out: object           # the graph's static outputs
    launches: tuple       # (kernel module, launches one replay makes)
    capture_s: float      # wall time of warm-up + capture


class GraphCache:
    """The captured graphs of one engine, with its lock, capture stream and
    memory pool."""

    def __init__(self, device: torch.device):
        self.device = device
        self.lock = threading.RLock()
        self._graphs: dict[tuple, _Entry] = {}
        self._state: tuple = ()      # tensors the graphs read, kept alive
        self._state_id: tuple | None = None
        self._stream = None
        self._pool = None
        self._done = None            # event after the last copy-out
        self.captures = 0            # graphs ever captured, never falls
        _CACHES.add(self)

    def __len__(self) -> int:
        return len(self._graphs)

    def capture_seconds(self) -> dict[tuple, float]:
        """Warm-up + capture wall time of each cached key."""
        with self.lock:
            return {key: e.capture_s for key, e in self._graphs.items()}

    def clear(self) -> int:
        """Drop every graph, their memory pool and the state they read,
        once the card has finished the engine's last replay, search or
        write (so no memory is freed under work still in flight on another
        stream). Returns the number of graphs dropped."""
        with self.lock:
            if self._done is not None:
                self._done.synchronize()
            dropped = len(self._graphs)
            self._graphs.clear()
            self._pool = None
            self._state, self._state_id = (), None
            return dropped

    @contextlib.contextmanager
    def ordered(self):
        """Hold the engine's lock with the current stream ordered after every
        earlier replay, eager search and write of the engine; what the block
        enqueues is ordered before every later one. On the CPU, the lock
        alone."""
        with self.lock:
            if self.device.type != "cuda":
                yield
                return
            with torch.cuda.device(self.device):
                stream = torch.cuda.current_stream()
                if self._done is not None:
                    stream.wait_event(self._done)
                try:
                    yield
                finally:
                    self._done = torch.cuda.Event()
                    self._done.record(stream)

    def run(self, key: tuple, state: tuple, fn: Callable, inputs: tuple):
        """``fn(*inputs)`` through the graph of ``key`` (a ``graph_key``,
        whose last field is the identity of ``state``), captured on the
        first call of the key. ``state`` is the tensors ``fn`` reads
        besides its inputs; ``inputs`` may hold None for an absent input.
        Returns clones of ``fn``'s outputs."""
        with self.lock, torch.cuda.device(self.device):
            sid = key[-1]
            if sid != self._state_id:
                self.clear()
                self._state, self._state_id = tuple(state), sid
            stream = torch.cuda.current_stream()
            if self._done is not None:
                stream.wait_event(self._done)
            entry = self._graphs.get(key)
            if entry is None:
                entry = self._capture(fn, inputs)
                self._graphs[key] = entry
                self.captures += 1
            for buf, x in zip(entry.inputs, inputs):
                if buf is not None:
                    buf.copy_(x)
            entry.graph.replay()
            for mod, n in entry.launches:
                mod.launches += n
            out = _clone(entry.out)
            self._done = torch.cuda.Event()
            self._done.record(stream)
            return out

    def _capture(self, fn: Callable, inputs: tuple) -> _Entry:
        t0 = time.perf_counter()
        static = tuple(None if x is None else x.clone() for x in inputs)
        if self._stream is None:
            self._stream = torch.cuda.Stream()
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        side = self._stream
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn(*static)          # resolves the verdicts; real launches
        mods = ops.KERNEL_MODULES
        before = [mod.launches for mod in mods]
        graph = torch.cuda.CUDAGraph()
        try:
            # thread_local: work another thread issues meanwhile (a
            # serving loop's eager calls) cannot invalidate this capture
            with torch.cuda.graph(graph, pool=self._pool, stream=side,
                                  capture_error_mode="thread_local"):
                out = fn(*static)
        finally:
            # recorded, not run: each replay adds them back
            made = [mod.launches - b for mod, b in zip(mods, before)]
            for mod, b in zip(mods, before):
                mod.launches = b
        torch.cuda.current_stream().wait_stream(side)
        return _Entry(graph=graph, inputs=static, out=out,
                      launches=tuple((mod, n) for mod, n in zip(mods, made)
                                     if n),
                      capture_s=time.perf_counter() - t0)

"""The serving loop: batcher -> engine dispatch -> futures + accounting
(counterpart of ``repro.serving.loop``).

One daemon thread owns the engine: it drains the ``Batcher``, pads each
batch to its shape bucket, runs ``SearchEngine.search_jit`` (the whole
coarse -> scan -> re-rank -> merge pipeline as ONE captured CUDA graph
replay: K1 and K2 on the stream configuration), then splits results/stats
back to per-request futures with a single device->host copy per batch (the
result's dists, ids and seven stats packed into one i32 tensor). Padding
rows are sliced off before anything reaches a caller or the
``StatsRegistry``. A loop over a ``ShardedEngine`` serves through its eager
``search`` (that engine has no graph path).

Callers interact through futures (``submit``) or asyncio (``asearch``):

    loop = ServingLoop(engine, rerank_mult=4)
    loop.start(warmup=True)        # pre-compile every (bucket, k) pair
    fut = loop.submit(q, k=10, tenant="alice")
    res = fut.result()             # ServeResult: dists, ids, stats, latency

``warmup`` pushes one dummy batch through every shape bucket so steady-state
traffic never captures a graph; ``metrics()`` exposes batch occupancy and
``compiles``, the graph captures its calls made on its own engine (deltas
of ``GraphCache.captures``, which never falls: a primary and a standby loop
in one process count their own), to verify exactly that.

Filtered & namespaced serving (docs/filtering.md): the loop can hold a
process-wide attribute filter bitmap (``filter_bits`` / ``set_filter``) and
each request can carry a ``namespace`` id. Both ride the dispatch as graph
inputs — mixed-namespace batches share buckets and graphs, and the per-row
``rows_filtered`` counter flows into ``ServeResult`` and ``TenantStats``.

Live mutation (docs/mutability.md): ``upsert`` / ``delete`` / ``compact``
forward to the engine, which writes in place under its graph cache's lock,
so a batch reads one epoch whole and the next dispatch reads the new one —
queries and mutations interleave with zero failed futures.
``metrics()`` reports the engine's current ``epoch`` and the cumulative
``rows_tombstoned`` the loop's queries probed past.

Replication (docs/persistence.md#replication): with a ``transport`` the
loop joins a primary/standby pair. ``role='primary'`` ships closed WAL
segments on a background thread and fences its writer against newer
terms; ``role='standby'`` replays the shipped stream into its engine
(serving reads the whole time), sheds writes with ``NotPrimary``, watches
the primary's heartbeat, and on ``promote()`` drains replay, bumps the
fencing term, snapshots, and starts accepting mutations — the failover
runbook in docs/serving.md walks the full drill.
"""
from __future__ import annotations

import asyncio
import threading
import time
from concurrent.futures import Future
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import persist
from repro_torch.engine import SearchEngine, ShardedEngine
from repro_torch.kernels.ops import (autotune_cache_size, load_autotune_cache,
                                     save_autotune_cache)
from repro_torch.serving.batcher import DEFAULT_BUCKETS, Batcher, Request
from repro_torch.serving.errors import LoopClosed, NotPrimary, Overloaded
from repro_torch.serving.stats import StatsRegistry


class ServeResult(NamedTuple):
    """What one request's future resolves to."""

    dists: np.ndarray     # (k,) f32 ascending
    ids: np.ndarray       # (k,) i32 global ids, -1 = no candidate
    lists_probed: int     # this query's QueryStats row
    codes_scanned: int
    reranked: int
    rows_filtered: int    # probed rows the loop's filter excluded (0 if none)
    rows_tombstoned: int  # probed slots holding tombstones (0 if none)
    lists_pruned: int     # coarse probes the margin policy dropped (0 under
    #                       probe_policy='fixed' — docs/anytime.md)
    tiles_skipped: int    # scan tiles the early-exit bound skipped (0
    #                       without early_exit)
    latency_s: float      # submit -> results on host


class LoopMetrics(NamedTuple):
    """Point-in-time serving-loop counters (see ``ServingLoop.metrics``)."""

    batches: int           # dispatches made
    rows_served: int       # real queries completed
    rows_padded: int       # zero-pad rows dispatched alongside them
    occupancy: float       # rows_served / (rows_served + rows_padded)
    compiles: int          # graph captures THIS loop's calls made on its
    #                        engine (incl. warmup)
    bucket_counts: dict    # bucket size -> dispatch count
    autotuned: int         # autotune sweeps THIS loop's dispatches triggered
    #                        (incl. warmup; only grows when scan_impl='auto'
    #                        or rerank_impl='auto' meets a new shape
    #                        signature)
    epoch: int             # the engine's mutation epoch at snapshot time
    rows_tombstoned: int   # probed tombstone slots summed over served rows
    lists_pruned: int      # margin-pruned probes summed over served rows
    tiles_skipped: int     # early-exited scan tiles summed over served rows
    auto_compactions: int  # compactions the loop's tombstone-ratio policy
    #                        triggered itself (0 with compact_at=None)
    rejects: int           # submits shed by the bounded queue (Overloaded;
    #                        0 with max_pending=None — docs/serving.md)
    deadline_misses: int   # queued requests failed past their deadline
    #                        before reaching a dispatch slot
    checkpoints: int       # background snapshots written (0 without
    #                        snapshot_dir — docs/persistence.md)
    role: str = "primary"  # 'primary' | 'standby' (docs/persistence.md
    #                        #replication; standbys shed writes, serve reads)
    term: int = 0          # fencing term this loop writes/replays under
    replication_lag_seqs: int = 0    # standby: acked records not yet applied
    replication_lag_s: float = 0.0   # standby: age of that primary heartbeat
    segments_shipped: int = 0        # primary: WAL segments published
    records_replayed: int = 0        # standby: records applied from the
    #                                  shipped stream


class ServingLoop:
    """Dynamic micro-batching server around one ``SearchEngine`` (or a
    ``ShardedEngine``, served eagerly).

    ``nprobe`` / ``rerank_mult`` are fixed per loop (they are static knobs of
    the graphs; run one loop per serving configuration). ``k`` stays
    per-request — the batcher groups requests by ``k``.
    """

    def __init__(self, engine: SearchEngine | ShardedEngine, *,
                 batcher: Batcher | None = None,
                 buckets: tuple[int, ...] = DEFAULT_BUCKETS,
                 max_wait_s: float = 0.002,
                 nprobe: int | None = None, rerank_mult: int | None = None,
                 stats: StatsRegistry | None = None,
                 warmup_cache: str | None = None,
                 filter_bits=None,
                 margin_tau: float | None = None,
                 compact_at: float | None = None,
                 max_pending: int | None = None,
                 snapshot_dir: str | None = None,
                 snapshot_every: float = 30.0,
                 role: str = "primary",
                 transport=None,
                 ship_every: float = 0.05,
                 poll_every: float = 0.02,
                 heartbeat_timeout: float | None = None,
                 on_failover=None,
                 standby_start_seq: int = 0):
        self.engine = engine
        # durable serving (docs/persistence.md): with snapshot_dir set the
        # loop makes the engine durable into that directory (initial
        # snapshot + WAL attach on a fresh dir; an engine recovered by
        # persist.open_engine is recognized and left as-is) and a
        # background thread checkpoints every snapshot_every seconds while
        # mutations arrive, truncating the WAL chain as it goes.
        if snapshot_every <= 0:
            raise ValueError(f"snapshot_every must be > 0, got {snapshot_every}")
        if role not in ("primary", "standby"):
            raise ValueError(f"role must be 'primary'|'standby', got {role!r}")
        if role == "standby" and transport is None:
            raise ValueError("role='standby' requires a transport to follow")
        if ship_every <= 0 or poll_every <= 0:
            raise ValueError("ship_every/poll_every must be > 0")
        self.snapshot_dir = snapshot_dir
        self.snapshot_every = float(snapshot_every)
        self.role = role
        self.transport = transport
        self.ship_every = float(ship_every)
        self.poll_every = float(poll_every)
        self.heartbeat_timeout = heartbeat_timeout
        self.on_failover = on_failover
        self._last_ckpt_seq = 0
        self._ckpt_thread: threading.Thread | None = None
        self._ckpt_error: Exception | None = None
        self._ship_thread: threading.Thread | None = None
        self._replay_thread: threading.Thread | None = None
        self._stop_replay = threading.Event()
        self._repl_error: Exception | None = None
        self._failover_fired = False
        self._shipper = None
        self._replica = None
        if role == "standby":
            # a standby never attaches a WAL — it replays the primary's
            # shipped records (write shedding below keeps it that way) and
            # only promote() makes it durable in its own right
            self._replica = persist.StandbyReplica(
                engine, transport, start_seq=standby_start_seq)
        elif snapshot_dir is not None:
            persist.ensure_attached(engine, snapshot_dir)
            manifest = persist.read_manifest(snapshot_dir)
            self._last_ckpt_seq = manifest["wal_seq"]
            if transport is not None:
                term = int(manifest.get("term", 0))
                self._shipper = persist.WALShipper(
                    engine, snapshot_dir, transport, term=term)
                # fence the local writer too: once a newer term exists the
                # next append fails, not just the next ship
                engine._wal.guard = persist.make_fence_guard(transport, term)
        elif transport is not None:
            raise ValueError(
                "a primary with a transport needs snapshot_dir (the WAL it "
                "ships lives there)")
        # per-loop margin width override (docs/anytime.md): traced, so two
        # loops over one engine can serve different latency tiers without
        # extra compiles. Only legal when the engine's probe_policy='margin'.
        if margin_tau is not None and engine.config.probe_policy != "margin":
            raise ValueError(
                "margin_tau given but the engine's probe_policy is "
                f"{engine.config.probe_policy!r}; build it with "
                "EngineConfig(probe_policy='margin')")
        self.margin_tau = None if margin_tau is None else float(margin_tau)
        # auto-compaction policy (docs/mutability.md): when the engine's
        # tombstone count reaches this fraction of total occupancy, the
        # dispatch thread runs compact() between batches. None = never
        # (the default — compaction stays an explicit operator action).
        if compact_at is not None and not 0.0 < compact_at <= 1.0:
            raise ValueError(
                f"compact_at must be in (0, 1], got {compact_at}")
        self.compact_at = None if compact_at is None else float(compact_at)
        # loop-level attribute filter: a (nlist, W) packed bitmap applied to
        # every dispatched batch (docs/filtering.md). Swap it atomically with
        # ``set_filter`` on attribute epoch changes — the values are traced,
        # so a swap never recompiles.
        self._sharded = isinstance(engine, ShardedEngine)
        self.filter_bits = self._as_filter(filter_bits)
        # path of a persisted autotune table (kernels.ops.save_autotune_cache
        # format): loaded before warmup so a fleet replica skips the timed
        # kernel sweeps its siblings already ran, re-saved after warmup so
        # first boot populates it. None = per-process sweeps only.
        self.warmup_cache = warmup_cache
        self.batcher = batcher or Batcher(buckets=buckets,
                                          max_wait_s=max_wait_s,
                                          max_pending=max_pending)
        self.nprobe = engine.config.nprobe if nprobe is None else int(nprobe)
        self.rerank_mult = (engine.config.rerank_mult if rerank_mult is None
                            else int(rerank_mult))
        if self.rerank_mult and (engine.base_s if self._sharded
                                 else engine.base) is None:
            raise ValueError("rerank_mult > 0 but the engine holds no base "
                             "vectors (build with keep_base=True)")
        self.stats = stats or StatsRegistry()
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._batches = 0
        self._rows_served = 0
        self._rows_padded = 0
        self._bucket_counts: dict[int, int] = {}
        self._compiles = 0
        self._autotuned = 0
        self._rows_tombstoned = 0
        self._lists_pruned = 0
        self._tiles_skipped = 0
        self._auto_compactions = 0
        self._checkpoints = 0
        self._dim = int((engine.centroids if self._sharded
                         else engine.index.centroids).shape[1])

    # -- lifecycle ----------------------------------------------------------

    def start(self, *, warmup: bool = False, warmup_ks: tuple[int, ...] = (10,)
              ) -> "ServingLoop":
        """Spawn the dispatch thread; optionally pre-compile every bucket.

        With ``warmup_cache`` set, the persisted autotune table is loaded
        before the warmup (so a fleet replica pays zero timed sweeps for
        signatures its siblings already resolved) and re-saved after it.

        A stopped loop can be started again (pending state was cancelled at
        stop; counters keep accumulating).
        """
        if self._thread is not None:
            raise RuntimeError("loop already started")
        self.batcher.reopen()
        if warmup:
            if self.warmup_cache:
                load_autotune_cache(self.warmup_cache)
            self.warmup(ks=warmup_ks)
            if self.warmup_cache:
                try:
                    save_autotune_cache(self.warmup_cache)
                except OSError:
                    # a read-only fleet mount (replicas share the file) or a
                    # missing parent dir must never stop a boot — the cache
                    # only saves re-timing, it is not required state
                    pass
        self._stop.clear()
        self._stop_replay.clear()
        self._thread = threading.Thread(target=self._run, name="repro-serve",
                                        daemon=True)
        self._thread.start()
        if self.role == "primary" and self.snapshot_dir is not None:
            self._ckpt_thread = threading.Thread(
                target=self._ckpt_run, name="repro-checkpoint", daemon=True)
            self._ckpt_thread.start()
        if self._shipper is not None:
            self._ship_thread = threading.Thread(
                target=self._ship_run, name="repro-ship", daemon=True)
            self._ship_thread.start()
        if self.role == "standby":
            self._replay_thread = threading.Thread(
                target=self._replay_run, name="repro-replay", daemon=True)
            self._replay_thread.start()
        return self

    def _shutdown(self, timeout: float) -> None:
        """Common teardown: stop + join EVERY background thread, then make
        durable state quiescent. Idempotent — ``stop``/``close`` in any
        order or repetition never leaves a dangling thread (the historical
        bug: ``close()`` racing a checkpoint skipped the join when the
        dispatch thread was already gone) and always flushes the WAL's
        group-commit tail so every acknowledged record is on disk.
        """
        self.batcher.close()
        self._stop.set()
        self._stop_replay.set()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None
        if self._ckpt_thread is not None:
            self._ckpt_thread.join(timeout)
            self._ckpt_thread = None
        if self._ship_thread is not None:
            self._ship_thread.join(timeout)
            self._ship_thread = None
        if (self._replay_thread is not None
                and self._replay_thread is not threading.current_thread()):
            self._replay_thread.join(timeout)
            self._replay_thread = None
        if self.role == "primary" and self.snapshot_dir is not None:
            self._checkpoint_if_dirty()
        if self._shipper is not None:
            try:  # best-effort final ship so a standby sees the full chain
                self._shipper.ship_once()
            except Exception:
                pass
        wal = getattr(self.engine, "_wal", None)
        if wal is not None:
            wal.flush()

    def stop(self, timeout: float = 5.0) -> None:
        """Stop dispatching; cancel anything still queued.

        With ``snapshot_dir`` set, a final checkpoint runs first so every
        acknowledged mutation is covered by the last snapshot (the WAL
        already covered it — this just shortens replay on the next boot).
        Stops the checkpoint/ship/replay threads too and flushes the WAL;
        idempotent, and safe to interleave with ``close``.
        """
        self._shutdown(timeout)
        while (reqs := self.batcher.next_batch(timeout=0)):
            for r in reqs:
                r.future.cancel()

    def close(self, timeout: float = 5.0) -> None:
        """Shut down and DRAIN: fail every still-pending future.

        Unlike ``stop`` (which cancels, for restart scenarios), ``close``
        resolves each queued request's future with a ``LoopClosed`` error —
        a caller blocked in ``future.result()`` gets a typed failure
        instead of waiting forever on a future nothing will ever run.
        """
        self._shutdown(timeout)
        while (reqs := self.batcher.next_batch(timeout=0)):
            for r in reqs:
                if not r.future.done():
                    r.future.set_exception(
                        LoopClosed("serving loop closed before dispatch"))

    def __enter__(self) -> "ServingLoop":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def warmup(self, ks: tuple[int, ...] = (10,)) -> None:
        """Compile the fused pipeline for every (bucket, k) pair up front.

        Warmup captures count toward ``metrics().compiles`` (they are real
        graphs); steady-state traffic after warmup should add zero.
        When the engine runs ``scan_impl='auto'`` (or ``rerank_impl='auto'``),
        tracing each bucket here also runs the kernel autotune sweep for that
        bucket's scan (G, cap, M, nlist) — and re-rank (Q, R, D, k, N) —
        signature (``kernels.ops.resolve_grouped_impl`` /
        ``resolve_rerank_impl``), so steady-state traffic never pays the
        timed micro-sweep either — ``metrics().autotuned`` should be flat
        after warmup. Both stages' verdicts persist through the same
        ``warmup_cache`` file.
        """
        for b in self.batcher.buckets:
            dummy = torch.zeros((b, self._dim), dtype=torch.float32)
            for k in ks:
                self._call_engine(dummy, k)

    # -- request entry points ------------------------------------------------

    def submit(self, query, k: int = 10, tenant: str = "default",
               namespace: int = -1, deadline_s: float | None = None) -> Future:
        """Enqueue one (D,) query -> Future[ServeResult].

        ``namespace`` >= 0 restricts the query to that engine namespace's
        lists (-1 = unrestricted). Namespaces are per-row traced values, so
        mixed-namespace requests still share shape buckets and compiles.

        ``deadline_s`` bounds the request's queue wait: still undispatched
        past it, the future fails with ``DeadlineExceeded`` and the request
        never reaches the engine. Raises ``Overloaded`` (counted per
        tenant) when the bounded queue is full — docs/serving.md runbook.
        """
        if self._thread is None:
            raise RuntimeError("loop is not running (call start())")
        q = np.asarray(query, np.float32)
        # reject wrong-D here, where the engine's D is known — a bad query
        # must fail alone, never poison the co-riders in its batch
        if q.shape != (self._dim,):
            raise ValueError(
                f"query shape {q.shape} does not match engine dim "
                f"({self._dim},)")
        if namespace >= 0:
            n_ns = self._n_namespaces()
            if n_ns is None:
                raise ValueError(
                    f"namespace={namespace} requested but the engine was "
                    "built without a namespace table")
            if namespace >= n_ns:
                raise ValueError(
                    f"namespace={namespace} out of range (engine holds "
                    f"{n_ns} namespaces)")
        try:
            return self.batcher.submit(q, k=k, tenant=tenant,
                                       namespace=namespace,
                                       deadline_s=deadline_s)
        except Overloaded:
            self.stats.record_reject(tenant)
            raise

    async def asearch(self, query, k: int = 10, tenant: str = "default",
                      namespace: int = -1) -> ServeResult:
        """Asyncio-native entry: await one query's ServeResult."""
        return await asyncio.wrap_future(
            self.submit(query, k=k, tenant=tenant, namespace=namespace))

    # -- live mutation (docs/mutability.md) ---------------------------------

    def upsert(self, ids, vecs, *, attrs=None) -> np.ndarray:
        """Insert/replace rows while serving.

        Delegates to ``SearchEngine.upsert`` under the engine's mutation
        lock; with a WAL attached the record is fsync'd before the engine
        writes, and the writes land between two batches, never inside one
        — no failed futures. Safe to call from any thread, running loop or
        not.

        On a standby, raises ``NotPrimary`` (graceful degradation: reads
        keep flowing, writes are shed until ``promote()``).
        """
        self._require_primary("upsert")
        return self.engine.upsert(ids, vecs, attrs=attrs)

    def delete(self, ids) -> int:
        """Tombstone rows while serving (see ``upsert`` for the epoch
        contract). Returns the number of rows deleted."""
        self._require_primary("delete")
        return self.engine.delete(ids)

    def compact(self, cap: int | None = None) -> int:
        """Rebuild tombstone-heavy lists into a fresh epoch while serving.

        At the same cap the lists are rewritten in place between two
        batches and the graphs keep serving. A cap change retires the scan
        kernels' autotune signatures and the engine's graphs; the next
        dispatch pays one re-sweep/capture, subsequent traffic is steady
        again.
        Returns the number of tombstoned slots reclaimed.
        """
        self._require_primary("compact")
        return self.engine.compact(cap=cap)

    def _require_primary(self, what: str) -> None:
        if self.role != "primary":
            raise NotPrimary(
                f"{what} refused: this loop is a standby replaying the "
                "primary's WAL — route writes to the primary or promote() "
                "this replica first (docs/serving.md)")

    def set_filter(self, filter_bits) -> None:
        """Swap the loop-level filter bitmap (None = unfiltered).

        Safe to call while serving: the reference swap is atomic and each
        dispatch reads it once. The bitmap is kept as a u8 tensor on the
        engine's device. Flipping between None and a bitmap changes the
        graph key and costs one capture per bucket; swapping one bitmap for
        another of the same shape never captures.
        """
        self.filter_bits = self._as_filter(filter_bits)

    def _as_filter(self, filter_bits):
        return (None if filter_bits is None else torch.as_tensor(
            filter_bits, dtype=torch.uint8, device=self.engine.device))

    def _n_namespaces(self) -> int | None:
        """Tenants of the engine's namespace table, None without one (a
        sharded engine holds it as (S, n_ns, L))."""
        if self._sharded:
            member = self.engine.member_s
            return None if member is None else int(member.shape[1])
        member = self.engine.ns_member
        return None if member is None else int(member.shape[0])

    def _captures(self) -> int:
        """Graph captures of this loop's engine so far (0 on a sharded
        engine, which captures nothing)."""
        return 0 if self._sharded else self.engine.graphs.captures

    # -- observability -------------------------------------------------------

    def metrics(self) -> LoopMetrics:
        lag = persist.ReplicationLag(0, 0.0)
        term = 0
        replayed = 0
        shipped = 0
        if self._replica is not None:
            if self.role == "standby":
                # a promoted loop keeps its replica only for the replay
                # counters: lag against its OWN heartbeats is meaningless
                lag = self._replica.lag()
            term = self._replica.max_term
            replayed = self._replica.records_replayed
        if self._shipper is not None:
            term = self._shipper.term
            shipped = self._shipper.segments_shipped
        with self._lock:
            total = self._rows_served + self._rows_padded
            return LoopMetrics(
                role=self.role,
                term=term,
                replication_lag_seqs=lag.seqs,
                replication_lag_s=lag.seconds,
                segments_shipped=shipped,
                records_replayed=replayed,
                batches=self._batches,
                rows_served=self._rows_served,
                rows_padded=self._rows_padded,
                occupancy=self._rows_served / total if total else 0.0,
                compiles=self._compiles,
                bucket_counts=dict(self._bucket_counts),
                autotuned=self._autotuned,
                epoch=self.engine.epoch,
                rows_tombstoned=self._rows_tombstoned,
                lists_pruned=self._lists_pruned,
                tiles_skipped=self._tiles_skipped,
                auto_compactions=self._auto_compactions,
                rejects=self.batcher.rejects,
                deadline_misses=self.batcher.deadline_misses,
                checkpoints=self._checkpoints,
            )

    # -- dispatch thread -----------------------------------------------------

    def _run(self) -> None:
        # BaseException, not Exception: a poisoned batch must fail ONLY its
        # own futures, never wedge or kill the dispatch thread — even on
        # exotic raises (KeyboardInterrupt delivered here, SystemExit from
        # a hook). The loop itself keeps serving subsequent batches.
        while not self._stop.is_set():
            reqs = self.batcher.next_batch(timeout=0.05)
            if not reqs:
                continue
            try:
                self._dispatch(reqs)
            except BaseException as e:  # engine failure -> fail the batch
                for r in reqs:
                    if not r.future.done():
                        r.future.set_exception(e)
                continue
            self._maybe_compact()

    # -- background checkpointing (docs/persistence.md) ---------------------

    def _ckpt_run(self) -> None:
        while not self._stop.wait(self.snapshot_every):
            self._checkpoint_if_dirty()

    def _checkpoint_if_dirty(self) -> None:
        """Snapshot iff mutations arrived since the last checkpoint.

        Runs on the dedicated checkpoint thread (and once at stop/close):
        the capture (device clones of the state) is atomic under the
        engine's mutation lock, the serialization works on the clones, so
        dispatches and mutators never stall behind segment I/O. A failed checkpoint is
        recorded (``checkpoint_error``) but must not kill the thread — the
        WAL still holds every acknowledged mutation.
        """
        wal = getattr(self.engine, "_wal", None)
        if wal is None or wal.last_seq == self._last_ckpt_seq:
            return
        try:
            manifest = persist.save_snapshot(self.engine, self.snapshot_dir)
        except Exception as e:
            self._ckpt_error = e
            return
        self._last_ckpt_seq = manifest["wal_seq"]
        with self._lock:
            self._checkpoints += 1

    def checkpoint(self) -> None:
        """Force a snapshot now (if any mutation arrived since the last);
        raises nothing — check ``checkpoint_error`` for the last failure."""
        if self.snapshot_dir is None:
            raise RuntimeError("loop has no snapshot_dir")
        self._checkpoint_if_dirty()

    @property
    def checkpoint_error(self) -> Exception | None:
        """Last background-checkpoint failure, None when healthy."""
        return self._ckpt_error

    # -- replication (docs/persistence.md#replication) -----------------------

    def _ship_run(self) -> None:
        """Primary's shipping thread: rotate + publish closed WAL segments
        every ``ship_every`` seconds. ``FencedError`` means a standby was
        promoted over us — shipping stops for good (the writer guard
        fences appends the same way); transient ``ReplicationError`` is
        recorded and retried next round (already-published segments are
        skipped, so a healed transport catches up exactly)."""
        while not self._stop.wait(self.ship_every):
            try:
                self._shipper.ship_once()
            except persist.FencedError as e:
                self._repl_error = e
                return
            except Exception as e:
                self._repl_error = e

    def _replay_run(self) -> None:
        """Standby's replay thread: poll + apply the shipped stream every
        ``poll_every`` seconds, and watch the primary's heartbeat —
        silence past ``heartbeat_timeout`` fires ``on_failover(self)``
        (the supervisor hook; it may call ``promote()`` directly). A
        primary that never wrote a heartbeat, or whose heartbeat file was
        deleted or damaged, counts as silent too: the silence clock
        starts when this thread does and only a readable heartbeat
        advances it. The hook fires once per silence episode — a fresh
        heartbeat re-arms the detector, so a standby that lost a
        promotion race fails over again when the NEXT primary dies.
        Replay errors are loud-and-stop: a standby that cannot follow the
        chain exactly keeps serving its current prefix, never a diverged
        one."""
        last_signal = time.time()  # no heartbeat ever = silent since start
        while not self._stop_replay.wait(self.poll_every):
            try:
                self._replica.poll_once()
            except Exception as e:
                self._repl_error = e
                return
            if self.heartbeat_timeout is None:
                continue
            hb = self.transport.read_heartbeat("primary")
            if hb is not None:
                last_signal = max(last_signal, float(hb.get("time", 0.0)))
            if time.time() - last_signal <= self.heartbeat_timeout:
                self._failover_fired = False  # fresh signal re-arms
            elif not self._failover_fired:
                self._failover_fired = True
                if self.on_failover is not None:
                    try:
                        self.on_failover(self)
                    except Exception as e:
                        self._repl_error = e

    def promote(self, timeout: float = 5.0) -> int:
        """Fenced failover: turn this standby into the primary; returns the
        new term. Safe to call from the ``on_failover`` hook (which runs
        on the replay thread) or from any other thread:

        1. stop the replay thread (joined unless we ARE it),
        2. drain every segment already shipped, bump the transport term
           (``FencedError`` if a newer promotion won the race — this loop
           then stays a standby: the replay thread is resumed and keeps
           following the winner's stream),
        3. snapshot the drained state into ``snapshot_dir`` under the new
           term and attach a fenced WAL writer,
        4. start accepting mutations, checkpointing, and shipping.

        Standby reads keep flowing throughout — the dispatch thread never
        pauses.
        """
        if self.role != "standby":
            raise RuntimeError("promote() is only valid on a standby loop")
        if self.snapshot_dir is None:
            raise RuntimeError(
                "promote() needs snapshot_dir — the promoted primary's "
                "durable directory")
        self._stop_replay.set()
        replay_thread = self._replay_thread
        if (replay_thread is not None
                and replay_thread is not threading.current_thread()):
            replay_thread.join(timeout)
        self._replay_thread = None
        try:
            new_term = self._replica.promote(self.snapshot_dir)
        except persist.FencedError:
            # Lost the race to a newer promotion: genuinely resume life
            # as a standby — replay must keep following the winner's
            # stream, not silently serve an ever-staler prefix.
            self._stop_replay.clear()
            if replay_thread is threading.current_thread():
                # we ARE the replay thread (the on_failover hook path):
                # its loop continues once the cleared event is seen
                self._replay_thread = replay_thread
            elif self._thread is not None:
                self._replay_thread = threading.Thread(
                    target=self._replay_run, name="repro-replay",
                    daemon=True)
                self._replay_thread.start()
            raise
        self.role = "primary"
        self._last_ckpt_seq = self._replica.applied_seq
        self._shipper = persist.WALShipper(
            self.engine, self.snapshot_dir, self.transport, term=new_term)
        if self._thread is not None:  # loop running: start primary threads
            self._ckpt_thread = threading.Thread(
                target=self._ckpt_run, name="repro-checkpoint", daemon=True)
            self._ckpt_thread.start()
            self._ship_thread = threading.Thread(
                target=self._ship_run, name="repro-ship", daemon=True)
            self._ship_thread.start()
        return new_term

    @property
    def replication_error(self) -> Exception | None:
        """Last ship/replay/failover-hook failure, None when healthy. A
        ``FencedError`` here on an old primary is the EXPECTED signature
        of having been failed over."""
        return self._repl_error

    def replication_lag(self) -> "persist.ReplicationLag":
        """Standby's lag behind the primary (0/0.0 on a primary — a
        promoted loop IS the primary now; comparing its frozen
        ``applied_seq`` against its own heartbeats would only mint an
        ever-growing bogus number)."""
        if self._replica is None or self.role != "standby":
            return persist.ReplicationLag(0, 0.0)
        return self._replica.lag()

    def _maybe_compact(self) -> None:
        """Auto-compaction: runs on the dispatch thread BETWEEN batches.

        With ``compact_at`` set, compact once the tombstone count reaches
        that fraction of the store's total occupancy (watermark slots). The
        check reads the tombstone count (a host int) and, only when it is
        nonzero, the watermarks' sum (one small device read); the compact
        is the same write an operator's is, so the next dispatch reads the
        fresh epoch. A failed
        compaction is swallowed (and not counted): a compaction hiccup must
        never take the serving thread down with it.
        """
        if self.compact_at is None:
            return
        tomb = self.engine.n_tombstones
        if not tomb:
            return
        sizes = (self.engine.lists_s if self._sharded
                 else self.engine.index.lists).sizes
        occupancy = int(sizes.sum())
        if tomb / max(1, occupancy) < self.compact_at:
            return
        try:
            self.engine.compact()
        except Exception:
            return  # a compaction hiccup must not kill the dispatch thread
        with self._lock:
            self._auto_compactions += 1

    def _call_engine(self, q, k: int, namespaces=None):
        """search_jit (``search`` on a sharded engine) + per-loop capture /
        autotune attribution. Captures are read off this loop's own engine
        (``GraphCache.captures`` deltas around the call), so another
        engine's graphs, a standby loop's in the same process included,
        never count here. Autotune
        sweeps are process-wide deltas around the call, the reference's
        rule.

        Key consistency: when the engine holds a namespace table the loop
        ALWAYS passes a namespaces array (all -1 for warmup and
        unrestricted batches) — so warmup and steady-state traffic share one
        graph per bucket instead of splitting on presence. Same for the
        loop-level filter bitmap.
        """
        if self._n_namespaces() is not None and namespaces is None:
            namespaces = np.full((q.shape[0],), -1, np.int32)
        c0 = self._captures()
        a0 = autotune_cache_size()
        search = (self.engine.search if self._sharded
                  else self.engine.search_jit)
        res = search(q, k, nprobe=self.nprobe, rerank_mult=self.rerank_mult,
                     filter_bits=self.filter_bits, namespaces=namespaces,
                     margin_tau=self.margin_tau)
        with self._lock:
            self._compiles += self._captures() - c0
            self._autotuned += autotune_cache_size() - a0
        return res

    def _dispatch(self, reqs: list[Request]) -> None:
        padded, bucket = self.batcher.form(reqs)
        n = len(reqs)
        ns = None
        if self._n_namespaces() is not None:
            # padding rows are unrestricted (-1): their results are dropped,
            # so the cheapest key-consistent value wins
            ns = np.full((bucket,), -1, np.int32)
            ns[:n] = [r.namespace for r in reqs]
        k = reqs[0].k
        # a host tensor: search_jit copies it into the graph's static input
        res = self._call_engine(torch.from_numpy(padded), k, namespaces=ns)
        # one device->host copy for the whole batch: dists (as their i32
        # bits), ids and the seven stats side by side
        packed = torch.cat([res.dists.view(torch.int32), res.ids,
                            torch.stack(tuple(res.stats), dim=1)],
                           dim=1).cpu().numpy()
        dists = packed[:, :k].view(np.float32)
        ids = packed[:, k:2 * k]
        lp, cs, rr, rf, rt, pr, ts = packed[:, 2 * k:].T
        t_done = time.monotonic()
        lats = [t_done - r.t_submit for r in reqs]

        for i, r in enumerate(reqs):
            r.future.set_result(ServeResult(
                dists=dists[i], ids=ids[i], lists_probed=int(lp[i]),
                codes_scanned=int(cs[i]), reranked=int(rr[i]),
                rows_filtered=int(rf[i]), rows_tombstoned=int(rt[i]),
                lists_pruned=int(pr[i]), tiles_skipped=int(ts[i]),
                latency_s=lats[i]))
        # padding rows [n:] are dropped on the floor here — accounting and
        # callers only ever see rows [:n]
        self.stats.record_batch([r.tenant for r in reqs], lp[:n], cs[:n],
                                rr[:n], lats, rf[:n], rt[:n], pr[:n], ts[:n])
        with self._lock:
            self._batches += 1
            self._rows_served += n
            self._rows_padded += bucket - n
            self._rows_tombstoned += int(rt[:n].sum())
            self._lists_pruned += int(pr[:n].sum())
            self._tiles_skipped += int(ts[:n].sum())
            self._bucket_counts[bucket] = self._bucket_counts.get(bucket, 0) + 1

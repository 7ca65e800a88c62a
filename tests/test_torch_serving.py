"""The port's serving layer (``repro_torch.serving``) on the CPU: what
``tests/test_serving.py`` covers for the batcher, the per-tenant stats, the
loop's lifecycle, deadlines, shedding, poisoned batches and padding, plus

- **parity**: the port's loop and the reference's ``ServingLoop``, over one
  ``repro``-built index carried over by ``interop``, serve the same
  requests with tie-aware ids and exact stats;
- the loop's ``compiles``: graph captures of its own engine only
  (``GraphCache.captures`` deltas around its calls). On the CPU
  ``search_jit`` captures nothing, so these tests drive the counter through
  a stand-in; ``tests/test_torch_cuda.py`` holds it on the card.
"""
import asyncio
import pathlib
import sys
import threading
import time

import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).parent))
import test_torch_persist as tp  # noqa: E402

from repro.serving import ServingLoop as JLoop  # noqa: E402
from repro_torch import persist  # noqa: E402
from repro_torch.core import lists as tlists  # noqa: E402
from repro_torch.engine import EngineConfig, SearchEngine, ShardedEngine  # noqa: E402
from repro_torch.serving import (Batcher, DeadlineExceeded,  # noqa: E402
                                 LoopClosed, Overloaded, ServingLoop,
                                 StatsRegistry, bucket_for, pad_to_bucket)

D = tp.D


def _queries():
    return tp._queries()


def make_loop(eng=None, **kw):
    kw.setdefault("max_wait_s", 0.005)
    return ServingLoop(eng if eng is not None else tp.port_engine(), **kw)


# ---------------------------------------------------------------------------
# batcher and stats (numpy only: the reference's behaviour, exactly)
# ---------------------------------------------------------------------------

def test_bucket_for_and_pad_to_bucket():
    assert [bucket_for(n) for n in (1, 2, 8, 9, 32, 33, 128)] == [
        1, 8, 8, 32, 32, 128, 128]
    with pytest.raises(ValueError):
        bucket_for(129)
    q = np.arange(6, dtype=np.float32).reshape(3, 2)
    out = pad_to_bucket(q, 8)
    assert out.shape == (8, 2) and out.dtype == np.float32
    np.testing.assert_array_equal(out[:3], q)
    assert not out[3:].any()
    with pytest.raises(ValueError):
        pad_to_bucket(q, 2)


def test_batcher_groups_fifo_by_k_and_caps_at_the_largest_bucket():
    b = Batcher(buckets=(1, 4), max_wait_s=0.0)
    futs = [b.submit(np.full(3, i, np.float32), k=10) for i in range(6)]
    other = b.submit(np.zeros(3, np.float32), k=5)
    first = b.next_batch(timeout=0.1)
    assert [r.future for r in first] == futs[:4]
    second = b.next_batch(timeout=0.1)
    assert [r.future for r in second] == futs[4:]
    assert [r.future for r in b.next_batch(timeout=0.1)] == [other]
    q, bucket = b.form(second)
    assert bucket == 4 and q.shape == (4, 3)


def test_batcher_waits_for_coriders_until_its_window():
    b = Batcher(buckets=(1, 8), max_wait_s=0.05)
    b.submit(np.zeros(3, np.float32), k=10)
    threading.Timer(0.01, lambda: b.submit(np.ones(3, np.float32),
                                           k=10)).start()
    t0 = time.monotonic()
    batch = b.next_batch(timeout=1.0)
    assert len(batch) == 2 and time.monotonic() - t0 < 1.0


def test_batcher_rejects_bad_input_sheds_and_purges():
    b = Batcher(buckets=(1,), max_wait_s=0.0, max_pending=1)
    with pytest.raises(ValueError):
        b.submit(np.zeros((2, 3), np.float32))
    with pytest.raises(ValueError):
        b.submit(np.zeros(3, np.float32), k=0)
    with pytest.raises(ValueError):
        Batcher(buckets=(8, 1))
    b.submit(np.zeros(3, np.float32), k=10)
    with pytest.raises(Overloaded):
        b.submit(np.ones(3, np.float32), k=10)
    assert b.rejects == 1
    assert b.next_batch(timeout=0.01) is not None
    f = b.submit(np.zeros(3, np.float32), k=10, deadline_s=0.005)
    time.sleep(0.02)
    assert b.next_batch(timeout=0.01) is None
    assert b.deadline_misses == 1
    with pytest.raises(DeadlineExceeded):
        f.result(timeout=1)
    with pytest.raises(ValueError, match="deadline_s"):
        b.submit(np.zeros(3, np.float32), k=10, deadline_s=0.0)
    b.close()
    with pytest.raises(LoopClosed):
        b.submit(np.zeros(3, np.float32), k=10)


def test_tenant_stats_aggregate_and_snapshot_in_threads():
    reg = StatsRegistry()
    ones = np.ones(2, np.int32)

    def work():
        for _ in range(200):
            reg.record_batch(["a", "b"], ones, 2 * ones, 3 * ones,
                             [0.001, 0.002], ones, ones, ones, ones)

    threads = [threading.Thread(target=work) for _ in range(4)]
    for t in threads:
        t.start()
    snap = reg.snapshot()
    for t in threads:
        t.join()
    a = reg.get("a")
    assert (a.queries, a.batches, a.codes_scanned, a.reranked) == (
        800, 800, 1600, 2400)
    assert a.rows_tombstoned == a.lists_pruned == a.tiles_skipped == 800
    assert a.latency_max_s == pytest.approx(0.001)
    reg.record_reject("c")
    assert reg.get("c").rejects == 1 and reg.get("zz").queries == 0
    assert all(s.queries <= 800 for s in snap.values())


# ---------------------------------------------------------------------------
# the loop
# ---------------------------------------------------------------------------

def test_padded_queries_never_leak_into_results():
    eng = tp.port_engine()
    q = _queries()
    loop = make_loop(eng).start(warmup=True)
    try:
        got = [f.result(timeout=30)
               for f in [loop.submit(q[i], k=8) for i in range(3)]]
    finally:
        loop.stop()
    direct = eng.search(q[:3], 8)
    for i, r in enumerate(got):
        np.testing.assert_array_equal(r.ids, direct.ids[i].numpy())
        np.testing.assert_array_equal(r.dists, direct.dists[i].numpy())
        assert r.ids.dtype == np.int32 and r.dists.dtype == np.float32
        assert r.codes_scanned == int(direct.stats.codes_scanned[i])
        assert r.reranked == int(direct.stats.reranked[i])
        assert r.latency_s > 0
    m = loop.metrics()
    assert (m.rows_served, m.batches, m.rows_padded) == (3, 1, 5)
    assert m.bucket_counts == {8: 1}
    assert sum(s.queries for s in loop.stats.snapshot().values()) == 3


def test_mixed_k_requests_never_share_a_batch_and_asyncio_works():
    loop = make_loop().start()
    q = _queries()
    try:
        fa, fb = loop.submit(q[0], k=10), loop.submit(q[1], k=5)
        ra, rb = fa.result(timeout=30), fb.result(timeout=30)
        assert ra.ids.shape == (10,) and rb.ids.shape == (5,)
        assert loop.metrics().batches == 2
        ids = asyncio.run(loop.asearch(q[0], k=10))
        np.testing.assert_array_equal(ids.ids, ra.ids)
    finally:
        loop.stop()


def test_the_loop_serves_filters_namespaces_and_writes():
    eng = tp.port_engine(attrs=True, namespaces=tp._member())
    q = _queries()
    fb = tlists.filter_from_attrs(eng.index.lists, lambda a: a % 5 != 1)
    loop = make_loop(eng, filter_bits=fb, max_wait_s=0.05).start()
    try:
        ns = [0, 1, 2, -1, 0, 1]
        futs = [loop.submit(q[i], k=8, namespace=ns[i]) for i in range(6)]
        got = [f.result(timeout=30) for f in futs]
        want = eng.search(q, 8, filter_bits=fb,
                          namespaces=np.array(ns, np.int32))
        np.testing.assert_array_equal(np.stack([r.ids for r in got]),
                                      want.ids.numpy())
        assert sum(r.rows_filtered for r in got) == int(
            want.stats.rows_filtered.sum())
        assert loop.filter_bits.dtype == torch.uint8
        with pytest.raises(ValueError, match="out of range"):
            loop.submit(q[0], namespace=3)
        loop.set_filter(None)
        assert loop.filter_bits is None
        loop.delete(np.arange(0, 50))
        loop.upsert(np.array([7000]), q[:1] + 0.0,
                    attrs=np.array([3], np.int32))
        r = loop.submit(q[0], k=1).result(timeout=30)
        assert r.ids[0] == 7000 and r.dists[0] == 0.0
        assert loop.metrics().epoch == 2
    finally:
        loop.stop()


def test_a_loop_over_a_sharded_engine_serves_eagerly():
    sh = ShardedEngine(tp.port_engine(), 2)
    q = _queries()
    loop = make_loop(sh, max_wait_s=0.05).start(warmup=True)
    try:
        got = [f.result(timeout=30)
               for f in [loop.submit(q[i], k=8) for i in range(6)]]
        loop.delete(np.arange(10))
    finally:
        loop.stop()
    want = sh.search(q, 8)
    assert sh.epoch == 1
    np.testing.assert_array_equal(np.stack([r.ids for r in got]),
                                  ShardedEngine(tp.port_engine(), 2).search(
                                      q, 8).ids.numpy())
    assert want.ids.shape == (6, 8)
    m = loop.metrics()
    assert m.compiles == 0 and m.rows_served == 6


def test_the_ports_loop_serves_what_the_references_serves():
    """One repro-built index, carried over by interop: the two loops answer
    the same requests with tie-aware ids, close distances and exact
    stats."""
    q = _queries()
    cfg = EngineConfig(nprobe=6, rerank_mult=2, scan_impl="stream",
                       rerank_impl="stream")
    ours = make_loop(tp.port_engine(cfg), buckets=(8,), max_wait_s=0.05)
    ref = JLoop(tp.ref_engine(cfg), buckets=(8,), max_wait_s=0.05)
    results = []
    for loop in (ours.start(), ref.start()):
        try:
            results.append([f.result(timeout=60) for f in
                            [loop.submit(q[i], k=8, tenant=f"t{i % 2}")
                             for i in range(6)]])
        finally:
            loop.stop()
    stats = ("lists_probed", "codes_scanned", "reranked", "rows_filtered",
             "rows_tombstoned", "lists_pruned", "tiles_skipped")

    class _Res:
        def __init__(self, rows):
            self.dists = np.stack([r.dists for r in rows])
            self.ids = np.stack([r.ids for r in rows])
            self.stats = type("S", (), {s: np.array([getattr(r, s)
                                                     for r in rows])
                                        for s in stats})()
            self.stats._fields = stats

    tp.assert_tie_aware(_Res(results[0]), _Res(results[1]))
    a, b = ours.stats.snapshot(), ref.stats.snapshot()
    for t in ("t0", "t1"):
        assert (a[t].queries, a[t].codes_scanned, a[t].reranked) == (
            b[t].queries, b[t].codes_scanned, b[t].reranked)


class _CapturingStandIn:
    """Wraps a CPU engine's ``search_jit`` so that each new (shape, k) key
    counts a capture on the engine's own graph cache, as the card does."""

    def __init__(self, eng):
        self.seen = set()
        real = eng.search_jit

        def search_jit(q, k, **kw):
            key = (tuple(q.shape), k)
            if key not in self.seen:
                self.seen.add(key)
                eng.graphs.captures += 1
            return real(q, k, **kw)

        eng.search_jit = search_jit


def test_compiles_count_the_captures_of_the_loops_own_engine():
    eng, other = tp.port_engine(), tp.port_engine()
    _CapturingStandIn(eng)
    _CapturingStandIn(other)
    q = _queries()
    loop = make_loop(eng, max_wait_s=0.02).start(warmup=True)
    try:
        warm = loop.metrics().compiles
        assert warm == len(loop.batcher.buckets)
        for burst in (1, 7, 3, 1):
            futs = [loop.submit(q[i % 6], k=10) for i in range(burst)]
            for f in futs:
                f.result(timeout=30)
        assert loop.metrics().compiles == warm  # steady: no new capture
        other.search_jit(q[:5], 3)  # another engine's capture
        other.graphs.captures += 5
        assert loop.metrics().compiles == warm
        loop.submit(q[0], k=3).result(timeout=30)  # a new key: one capture
        assert loop.metrics().compiles == warm + 1
    finally:
        loop.stop()


def test_wrong_dim_rerank_without_base_and_restart():
    q = _queries()
    bare = SearchEngine(tp.port_engine().index)
    with pytest.raises(ValueError, match="base"):
        ServingLoop(bare, rerank_mult=2)
    with pytest.raises(ValueError, match="margin_tau"):
        ServingLoop(tp.port_engine(), margin_tau=0.3)
    loop = make_loop().start()
    try:
        good = loop.submit(q[0], k=10)
        with pytest.raises(ValueError, match="does not match engine dim"):
            loop.submit(np.zeros(7, np.float32), k=10)
        assert good.result(timeout=30).ids.shape == (10,)
    finally:
        loop.stop()
    with pytest.raises(RuntimeError, match="not running"):
        loop.submit(q[0], k=10)
    loop.start()
    try:
        assert loop.submit(q[1], k=10).result(timeout=30).ids.shape == (10,)
        assert loop.metrics().rows_served == 2
    finally:
        loop.stop()


def _gate_engine(eng):
    gate = threading.Event()
    calls = []
    real = eng.search_jit

    def gated(q, k, **kw):
        calls.append(int(q.shape[0]))
        gate.wait(60)
        return real(q, k, **kw)

    eng.search_jit = gated
    return gate, calls


def _wait_queue_drained(loop, timeout=10.0):
    t0 = time.monotonic()
    while len(loop.batcher._queue) and time.monotonic() - t0 < timeout:
        time.sleep(0.005)
    assert not len(loop.batcher._queue)


def test_bounded_queue_sheds_and_deadlines_never_reach_the_engine():
    eng = tp.port_engine()
    gate, calls = _gate_engine(eng)
    q = _queries()
    loop = ServingLoop(eng, buckets=(1,), max_wait_s=0.0, max_pending=2)
    loop.start()
    try:
        f0 = loop.submit(q[0], k=10, tenant="flood")
        _wait_queue_drained(loop)
        f1 = loop.submit(q[1], k=10, tenant="flood")
        f_dead = loop.submit(q[2], k=10, deadline_s=0.01)
        with pytest.raises(Overloaded):
            loop.submit(q[3], k=10, tenant="flood")
        assert loop.metrics().rejects == 1
        assert loop.stats.get("flood").rejects == 1
        time.sleep(0.05)
        gate.set()
        with pytest.raises(DeadlineExceeded):
            f_dead.result(timeout=60)
        for f in (f0, f1):
            assert f.result(timeout=60).ids.shape == (10,)
        assert calls == [1, 1]
        assert loop.metrics().deadline_misses == 1
    finally:
        gate.set()
        loop.stop()


def test_an_engine_failure_fails_its_batch_only():
    eng = tp.port_engine()
    real = eng.search_jit
    armed = [True]

    def flaky(q, k, **kw):
        if armed[0]:
            armed[0] = False
            raise RuntimeError("injected engine failure")
        return real(q, k, **kw)

    eng.search_jit = flaky
    q = _queries()
    loop = ServingLoop(eng, buckets=(1,), max_wait_s=0.0).start()
    try:
        with pytest.raises(RuntimeError, match="injected"):
            loop.submit(q[0], k=10).result(timeout=60)
        assert loop.submit(q[1], k=10).result(timeout=60).ids.shape == (10,)
        assert loop.metrics().batches == 1
    finally:
        loop.stop()


def test_close_drains_pending_futures_with_a_typed_error():
    eng = tp.port_engine()
    gate, _calls = _gate_engine(eng)
    q = _queries()
    loop = ServingLoop(eng, buckets=(1,), max_wait_s=0.0).start()
    f0 = loop.submit(q[0], k=10)
    _wait_queue_drained(loop)
    f1, f2 = loop.submit(q[1], k=10), loop.submit(q[2], k=10)
    loop.close(timeout=0.2)
    for f in (f1, f2):
        with pytest.raises(LoopClosed):
            f.result(timeout=10)
    with pytest.raises(RuntimeError, match="not running"):
        loop.submit(q[3], k=10)
    gate.set()
    assert f0.result(timeout=120).ids.shape == (10,)
    if loop._thread is not None:
        loop._thread.join(10)


def test_durable_loop_checkpoints_and_auto_compacts(tmp_path):
    eng = tp.port_engine()
    d = str(tmp_path / "d")
    loop = make_loop(eng, snapshot_dir=d, snapshot_every=60.0,
                     compact_at=0.01).start()
    q = _queries()
    try:
        loop.delete(np.arange(0, 100))
        loop.submit(q[0], k=8).result(timeout=30)
        # the dispatch thread compacts between batches, after resolving
        t0 = time.monotonic()
        while (loop.metrics().auto_compactions == 0
               and time.monotonic() - t0 < 10):
            time.sleep(0.005)
        assert loop.metrics().auto_compactions == 1
        assert eng.n_tombstones == 0
        loop.checkpoint()
        assert loop.metrics().checkpoints == 1
        assert loop.checkpoint_error is None
        m = persist.read_manifest(d)
        assert m["wal_seq"] == 2 and m["delta"]["capture_s"] >= 0
    finally:
        loop.close()
    rec, info = tp._open(d, attach=False)
    assert info.last_seq == 2 and info.replayed == 0
    tp.assert_same_results(eng, rec, q)
    with pytest.raises(RuntimeError, match="snapshot_dir"):
        make_loop().checkpoint()

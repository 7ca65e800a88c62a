"""The port's replication tier (``repro_torch.persist.replicate``) and the
serving loop's roles, on the CPU.

- Ship and replay bit for bit (both transports), reads while lagging,
  duplicate delivery, a dropped, torn or flipped frame failing loudly,
  bounded retries, the term chart's stale records.
- **Cross-package shipping**: a ``repro`` primary with a ``repro_torch``
  standby and the other way round, over one ``DirTransport``; the ship
  frames and segment names are the reference's bytes. The standby equals
  the primary (tie-aware, stats exact) and its promotion fences the other
  package's primary.
- Fenced failover holds exactly the acknowledged prefix; a lost promotion
  race resumes as a standby; heartbeat failover; a loop pair sheds writes
  on the standby; ``close()`` joins every thread.
"""
import os
import pathlib
import sys
import threading
import time

import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).parent))
import _torch_faults as tfaults  # noqa: E402
import test_persist as jp  # noqa: E402
import test_torch_persist as tp  # noqa: E402  (port engines, helpers)

from repro import persist as jpersist  # noqa: E402
from repro_torch import persist  # noqa: E402
from repro_torch.engine import ShardedEngine  # noqa: E402
from repro_torch.persist import io as tpio  # noqa: E402
from repro_torch.persist import wal as twal  # noqa: E402
from repro_torch.serving import NotPrimary, ServingLoop  # noqa: E402

D = tp.D
apply_ops, assert_same_results, port_engine = (tp.apply_ops,
                                               tp.assert_same_results,
                                               tp.port_engine)


def _transport(kind, tmp_path):
    if kind == "dir":
        return persist.DirTransport(str(tmp_path / "ship"))
    return persist.PipeTransport()


def _pair(tmp_path, kind="pipe"):
    """(primary, shipper, standby, replica, transport) ready to stream."""
    pdir = str(tmp_path / "primary")
    primary = port_engine()
    persist.ensure_attached(primary, pdir)
    transport = _transport(kind, tmp_path)
    shipper = persist.WALShipper(primary, pdir, transport)
    standby = port_engine()
    replica = persist.StandbyReplica(standby, transport)
    return primary, shipper, standby, replica, transport


def _q():
    return tp._queries()


# ---------------------------------------------------------------------------
# ship -> replay
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["dir", "pipe"])
def test_ship_replay_bit_for_bit(tmp_path, kind):
    primary, shipper, standby, replica, _ = _pair(tmp_path, kind)
    ops = jp.scripted_ops(7)
    for i, op in enumerate(ops):
        apply_ops(primary, [op])
        shipper.ship_once()
        replica.poll_once()
        assert replica.applied_seq == i + 1
    assert_same_results(primary, standby, _q())
    assert (standby.epoch, standby.n_tombstones) == (primary.epoch,
                                                     primary.n_tombstones)
    assert replica.records_replayed == len(ops)
    assert replica.lag() == persist.ReplicationLag(0, 0.0)


def test_standby_serves_reads_while_lagging_and_dedups(tmp_path):
    primary, shipper, standby, replica, _ = _pair(tmp_path)
    ops = jp.scripted_ops(4)
    apply_ops(primary, ops[:2])
    shipper.ship_once()
    replica.poll_once()
    want = standby.search(_q(), 8)
    apply_ops(primary, ops[2:])
    shipper.ship_once()  # shipped, not yet polled
    lag = replica.lag()
    assert lag.seqs == 2 and lag.seconds >= 0.0
    assert torch.equal(standby.search(_q(), 8).ids, want.ids)
    replica.poll_once()
    assert replica.lag() == persist.ReplicationLag(0, 0.0)
    assert_same_results(primary, standby, _q())
    # duplicate delivery: both sides forget their dedup state
    want = standby.search(_q(), 8)
    shipper._published.clear()
    shipper.ship_once()
    replica._seen.clear()
    assert replica.poll_once() == 0
    assert torch.equal(standby.search(_q(), 8).ids, want.ids)


def test_dropped_torn_and_flipped_frames_are_loud(tmp_path):
    primary, shipper, _s, _r, transport = _pair(tmp_path, "dir")
    for op in jp.scripted_ops(4):
        apply_ops(primary, [op])
        shipper.ship_once()  # one segment an op
    names = transport.list_segments()
    assert len(names) >= 3
    seg = os.path.join(transport.directory, "seg-" + names[0])
    pristine = tpio.read_bytes(seg)
    tfaults.truncate_file(seg, 0.6)
    with pytest.raises(persist.ReplicationError):
        persist.StandbyReplica(port_engine(), transport).poll_once()
    for seed in range(4):
        tpio.write_bytes(seg, pristine)
        tfaults.flip_byte_in(seg, seed=seed)
        with pytest.raises((persist.ReplicationError,
                            persist.CorruptWALError)):
            persist.StandbyReplica(port_engine(), transport).poll_once()
    tpio.write_bytes(seg, pristine)
    os.remove(os.path.join(transport.directory, "seg-" + names[1]))
    with pytest.raises(persist.ReplicationError, match="gap"):
        persist.StandbyReplica(port_engine(), transport).poll_once()


class _FlakyTransport:
    """Wraps a transport; fails the first ``fails_left`` publish/fetch
    calls."""

    def __init__(self, inner, n_fail):
        self.inner = inner
        self.fails_left = n_fail

    def _maybe_fail(self):
        if self.fails_left > 0:
            self.fails_left -= 1
            raise OSError("simulated transport outage")

    def publish(self, name, data, *, term):
        self._maybe_fail()
        self.inner.publish(name, data, term=term)

    def fetch(self, name):
        self._maybe_fail()
        return self.inner.fetch(name)

    def __getattr__(self, attr):
        return getattr(self.inner, attr)


def test_transport_retries_are_bounded_then_loud(tmp_path):
    pdir = str(tmp_path / "p")
    primary = port_engine()
    persist.ensure_attached(primary, pdir)
    apply_ops(primary, jp.scripted_ops(2))
    flaky = _FlakyTransport(persist.PipeTransport(), n_fail=2)
    shipper = persist.WALShipper(primary, pdir, flaky, max_retries=3,
                                 backoff_s=0.001)
    assert shipper.ship_once() == 1
    replica = persist.StandbyReplica(port_engine(), flaky)
    flaky.fails_left = 2
    assert replica.poll_once() == 2
    apply_ops(primary, jp.scripted_ops(2, seed=29))
    flaky.fails_left = 99
    with pytest.raises(persist.ReplicationError, match="attempts"):
        shipper.ship_once()
    flaky.fails_left = 0
    assert shipper.ship_once() == 1
    assert replica.poll_once() == 2
    assert_same_results(primary, replica.engine, _q())


# ---------------------------------------------------------------------------
# the reference's frames, either package on either side
# ---------------------------------------------------------------------------

def test_ship_frames_and_names_are_the_references():
    payload = os.urandom(777)
    assert persist.encode_ship_frame(3, 41, payload) == \
        jpersist.encode_ship_frame(3, 41, payload)
    name = twal.wal_name(41)
    assert persist.ship_segment_name(3, name) == \
        jpersist.ship_segment_name(3, name)
    frame = jpersist.encode_ship_frame(3, 41, payload)
    assert persist.decode_ship_frame(frame) == (3, 41, payload)


@pytest.mark.parametrize("primary_pkg", ["repro", "repro_torch"])
def test_shipping_across_packages(tmp_path, primary_pkg):
    """A primary of one package ships through a ``DirTransport`` to a warm
    standby of the other; the standby equals the primary and, once
    promoted, fences it: its next append and its next ship raise."""
    if primary_pkg == "repro":
        pp, primary, standby_pkg = jpersist, tp.ref_engine(), persist
        standby = port_engine()
    else:
        pp, primary, standby_pkg = persist, port_engine(), jpersist
        standby = tp.ref_engine()
    pdir, sdir = str(tmp_path / "primary"), str(tmp_path / "standby")
    pp.ensure_attached(primary, pdir)
    transport = pp.DirTransport(str(tmp_path / "ship"))
    shipper = pp.WALShipper(primary, pdir, transport, term=0)
    primary._wal.guard = pp.make_fence_guard(transport, 0)
    ops = jp.scripted_ops(7)
    apply_ops(primary, ops[:4])
    shipper.ship_once()
    apply_ops(primary, ops[4:])
    shipper.ship_once()
    replica = standby_pkg.StandbyReplica(
        standby, standby_pkg.DirTransport(str(tmp_path / "ship")))
    assert replica.poll_once() == len(ops)
    q = tp._queries()
    tp.assert_tie_aware(standby.search(q, 8), primary.search(q, 8))
    assert (standby.epoch, standby.n_tombstones) == (primary.epoch,
                                                     primary.n_tombstones)
    assert replica.promote(sdir) == 1
    with pytest.raises(pp.FencedError):
        shipper.ship_once()
    with pytest.raises(pp.FencedError):
        primary.delete(np.arange(3))
    standby.upsert(np.array([9001]), np.ones((1, D), np.float32))
    kw = {"device": "cpu"} if standby_pkg is persist else {}
    rec, info = standby_pkg.open_engine(sdir, attach=False, **kw)
    assert info.term == 1 and info.wal_seq == len(ops) and info.replayed == 1


# ---------------------------------------------------------------------------
# fenced failover
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["dir", "pipe"])
def test_fenced_failover_holds_the_acked_prefix_exactly(tmp_path, kind):
    primary, shipper, standby, replica, transport = _pair(tmp_path, kind)
    primary._wal.guard = persist.make_fence_guard(transport, 0)
    ops = jp.scripted_ops(6)
    acked = 4
    apply_ops(primary, ops[:acked])
    shipper.ship_once()
    replica.poll_once()
    apply_ops(primary, ops[acked:])  # logged, never shipped: not acked
    assert replica.promote(str(tmp_path / "standby")) == 1
    rebuild = port_engine()
    apply_ops(rebuild, ops[:acked])
    assert_same_results(rebuild, standby, _q())
    with pytest.raises(persist.FencedError):
        shipper.ship_once()
    before = primary.search(_q(), 8)
    with pytest.raises(persist.FencedError):
        primary.upsert(np.array([9000]), np.zeros((1, D), np.float32))
    assert torch.equal(primary.search(_q(), 8).ids, before.ids)
    standby.upsert(np.array([9001, 9002]), np.ones((2, D), np.float32))
    rec, info = tp._open(str(tmp_path / "standby"), attach=False)
    assert info.term == 1 and info.wal_seq == acked and info.replayed == 1
    assert_same_results(standby, rec, _q())


def test_a_lost_promotion_race_is_loud_and_changes_nothing(tmp_path):
    primary, shipper, _standby, replica, transport = _pair(tmp_path)
    apply_ops(primary, jp.scripted_ops(2))
    shipper.ship_once()
    replica.poll_once()
    loser = persist.StandbyReplica(port_engine(), transport)
    loser.poll_once()
    assert replica.promote(str(tmp_path / "win")) == 1
    with pytest.raises(persist.FencedError):
        loser.promote(str(tmp_path / "lose"), term=1)
    assert loser.engine._wal is None
    assert not os.path.exists(os.path.join(str(tmp_path / "lose"),
                                           persist.MANIFEST_NAME))


def test_stale_term_records_are_skipped_by_the_term_chart(tmp_path):
    primary, shipper, standby, replica, transport = _pair(tmp_path)
    pdir = str(tmp_path / "primary")
    ops = jp.scripted_ops(6)
    apply_ops(primary, ops[:4])
    shipper.ship_once()
    replica.poll_once()
    assert replica.promote(str(tmp_path / "win")) == 1
    assert transport.term_chart() == [(1, 5)]
    apply_ops(primary, ops[4:])  # the deposed primary's seqs 5-6
    primary._wal.rotate(pdir)
    stale = dict(twal.wal_files(pdir))[5]
    transport._segments[persist.ship_segment_name(
        0, os.path.basename(stale))] = persist.encode_ship_frame(
            0, 5, tpio.read_bytes(stale))
    standby.upsert(np.arange(5000, 5010), np.random.default_rng(13).normal(
        size=(10, D)).astype(np.float32))
    win = persist.WALShipper(standby, str(tmp_path / "win"), transport,
                             term=1)
    assert win.ship_once() == 1
    names = transport.list_segments()
    assert [persist.parse_ship_name(n)[0] for n in names] == [0, 0, 1]
    follower = persist.StandbyReplica(port_engine(), transport)
    assert follower.poll_once() == 5
    assert follower.records_stale == 2 and follower.applied_seq == 5
    assert_same_results(standby, follower.engine, _q())


def test_sharded_standby_and_promotion(tmp_path):
    pdir = str(tmp_path / "p")
    primary = ShardedEngine(port_engine(), 2)
    persist.ensure_attached(primary, pdir)
    transport = persist.PipeTransport()
    shipper = persist.WALShipper(primary, pdir, transport)
    standby = ShardedEngine(port_engine(), 2)
    replica = persist.StandbyReplica(standby, transport)
    apply_ops(primary, jp.scripted_ops(5))
    shipper.ship_once()
    replica.poll_once()
    assert_same_results(primary, standby, _q(), calls=("search",))
    term = replica.promote(str(tmp_path / "s"))
    rec, info = tp._open(str(tmp_path / "s"), attach=False)
    assert isinstance(rec, ShardedEngine) and info.term == term
    assert_same_results(standby, rec, _q(), calls=("search",))


# ---------------------------------------------------------------------------
# ServingLoop roles
# ---------------------------------------------------------------------------

def _wait_for(pred, timeout=10.0, every=0.01):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if pred():
            return True
        time.sleep(every)
    return False


def test_a_loop_pair_follows_and_sheds_writes_on_the_standby(tmp_path):
    transport = persist.PipeTransport()
    pl = ServingLoop(port_engine(), snapshot_dir=str(tmp_path / "p"),
                     transport=transport, ship_every=0.01,
                     snapshot_every=60.0).start()
    sl = ServingLoop(port_engine(), role="standby", transport=transport,
                     snapshot_dir=str(tmp_path / "s"),
                     poll_every=0.01).start()
    try:
        for op in jp.scripted_ops(3):
            apply_ops(pl, [op])
        with pytest.raises(NotPrimary):
            sl.upsert(np.array([1]), np.ones((1, D), np.float32))
        with pytest.raises(NotPrimary):
            sl.delete(np.array([1]))
        with pytest.raises(NotPrimary):
            sl.compact()
        assert _wait_for(lambda: sl.metrics().records_replayed == 3)
        q = _q()
        ra = pl.submit(q[0], k=8).result(10)
        rb = sl.submit(q[0], k=8).result(10)
        np.testing.assert_array_equal(ra.ids, rb.ids)
        np.testing.assert_array_equal(ra.dists, rb.dists)
        mp, ms = pl.metrics(), sl.metrics()
        assert mp.role == "primary" and mp.segments_shipped >= 1
        assert ms.role == "standby" and ms.records_replayed == 3
        assert ms.replication_lag_seqs == 0
    finally:
        sl.close()
        pl.close()


def test_heartbeat_failover_promotes_and_fences_the_old_primary(tmp_path):
    transport = persist.PipeTransport()
    pl = ServingLoop(port_engine(), snapshot_dir=str(tmp_path / "p"),
                     transport=transport, ship_every=0.01,
                     snapshot_every=60.0).start()
    promoted = []
    sl = ServingLoop(port_engine(), role="standby", transport=transport,
                     snapshot_dir=str(tmp_path / "s"), poll_every=0.01,
                     heartbeat_timeout=0.25,
                     on_failover=lambda loop: promoted.append(
                         loop.promote())).start()
    try:
        rng = np.random.default_rng(5)
        pl.upsert(np.arange(2000, 2020),
                  rng.normal(size=(20, D)).astype(np.float32))
        assert _wait_for(lambda: sl.metrics().records_replayed == 1)
        q = _q()
        want = sl.submit(q[0], k=8).result(10)
        pl.stop()  # heartbeats cease
        assert _wait_for(lambda: bool(promoted)), "failover never fired"
        assert promoted == [1] and sl.role == "primary"
        got = sl.submit(q[0], k=8).result(10)
        np.testing.assert_array_equal(want.ids, got.ids)
        sl.upsert(np.arange(3000, 3010),
                  rng.normal(size=(10, D)).astype(np.float32))
        assert _wait_for(lambda: sl.metrics().segments_shipped >= 1)
        m = sl.metrics()
        assert m.term == 1
        assert (m.replication_lag_seqs, m.replication_lag_s) == (0, 0.0)
        with pytest.raises(persist.FencedError):
            pl.upsert(np.array([1]),
                      rng.normal(size=(1, D)).astype(np.float32))
    finally:
        sl.close()
        pl.close()


def test_a_promote_that_loses_the_race_resumes_as_a_standby(tmp_path):
    transport = persist.PipeTransport()
    pl = ServingLoop(port_engine(), snapshot_dir=str(tmp_path / "p"),
                     transport=transport, ship_every=0.01,
                     snapshot_every=60.0).start()
    sl = ServingLoop(port_engine(), role="standby", transport=transport,
                     snapshot_dir=str(tmp_path / "s"),
                     poll_every=0.01).start()
    try:
        rng = np.random.default_rng(11)
        pl.upsert(np.arange(4000, 4010),
                  rng.normal(size=(10, D)).astype(np.float32))
        assert _wait_for(lambda: sl.metrics().records_replayed == 1)

        def lose(directory, **kw):
            raise persist.FencedError("a newer promotion won the race")

        orig = sl._replica.promote
        sl._replica.promote = lose
        try:
            with pytest.raises(persist.FencedError):
                sl.promote()
        finally:
            sl._replica.promote = orig
        assert sl.role == "standby"
        assert sl._replay_thread is not None and sl._replay_thread.is_alive()
        with pytest.raises(NotPrimary):
            sl.delete(np.array([1]))
        pl.upsert(np.arange(4100, 4110),
                  rng.normal(size=(10, D)).astype(np.float32))
        assert _wait_for(lambda: sl.metrics().records_replayed == 2)
    finally:
        sl.close()
        pl.close()


def test_failover_fires_without_any_primary_heartbeat():
    transport = persist.PipeTransport()
    fired = []
    sl = ServingLoop(port_engine(), role="standby", transport=transport,
                     poll_every=0.01, heartbeat_timeout=0.2,
                     on_failover=lambda loop: fired.append(1)).start()
    try:
        assert transport.read_heartbeat("primary") is None
        assert _wait_for(lambda: bool(fired))
    finally:
        sl.close()


def test_close_is_idempotent_joins_every_thread_and_flushes(tmp_path):
    eng = port_engine()
    loop = ServingLoop(eng, snapshot_dir=str(tmp_path / "d"),
                       snapshot_every=0.01).start()
    eng._wal.fsync_interval = 3600.0  # leave a group-commit tail pending
    apply_ops(loop, jp.scripted_ops(3))
    loop.close()
    loop.close()
    loop.stop()
    assert loop._thread is None and loop._ckpt_thread is None
    assert not [t for t in threading.enumerate()
                if t.name.startswith("repro-")]
    assert eng._wal._pending_fsync == 0
    assert loop.checkpoint_error is None
    rec, info = tp._open(str(tmp_path / "d"), attach=False)
    assert info.last_seq == 3
    assert_same_results(eng, rec, _q())

"""The port's sharding held against the JAX reference on the CPU.

- ``round_robin_perm``, ``partition_lists``, ``partition_filter`` and
  ``partition_base`` bit for bit (``partition_base``'s norms within f32
  tolerance: each package sums x*x in its own order); ``tournament_topk``
  bit for bit; the shard merge puts ties on the lowest shard.
- ``ShardedEngine.search`` (shards in turn) against the reference's vmap
  path at S in {1, 2, 3, 4}: plain, filtered, namespaced and margin with
  tau = inf; ids tie-aware, distances within rtol 1e-5 and 1e-6 x
  (||q||^2 + max ||x||^2), all seven ``QueryStats`` exact.
- The mutation program of the reference's sharded oracle test, held to the
  single-host port engine (tie-aware, the same tolerance, no deleted id
  back) and to
  the reference's sharded engine; why the reference's test fails.
- The ``torch.distributed`` path under gloo, in subprocesses with their
  own timeout: bit for bit equal to the in-turn path.
"""
import functools
import os
import pathlib
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ivf as jivf
from repro.core import lists as jlists
from repro.core import topk as jtopk
from repro.engine import ShardedEngine as JSharded
from repro_torch.core import lists as tlists
from repro_torch.core import topk as ttopk
from repro_torch.engine import EngineConfig, ShardedEngine

sys.path.insert(0, str(pathlib.Path(__file__).parent))
import test_torch_mutation as tmut  # noqa: E402  (the shared index)

RTOL = 1e-5
D = tmut.D
_HARNESS = pathlib.Path(__file__).with_name("_torch_dist_harness.py")
CONFIGS = {
    "stream": dict(nprobe=4, rerank_mult=4, scan_impl="stream",
                   rerank_impl="stream"),
    "gathered": dict(nprobe=4, rerank_mult=4),
    "fastscan": dict(nprobe=4, rerank_mult=0, scan_impl="stream"),
}


@functools.lru_cache(maxsize=None)
def _atol() -> float:
    """1e-6 x (max ||q||^2 + max ||x||^2): the rounding of the norms + GEMM
    distance, whose terms cancel (the K2 tolerance). Each framework, and
    the reference under its shard axis, rounds them its own way."""
    ds, _ = tmut._built()
    q, x = np.asarray(ds.queries), np.asarray(ds.base)
    return 1e-6 * float((q * q).sum(1).max() + (x * x).sum(1).max())


def assert_tie_aware(got_v, got_i, want_v, want_i, rtol=RTOL, atol=None):
    """Values within rtol and atol (default ``_atol()``); ids equal up to
    order inside runs of values that close to each other."""
    atol = _atol() if atol is None else atol
    got_v, want_v = np.asarray(got_v), np.asarray(want_v)
    got_i, want_i = np.asarray(got_i), np.asarray(want_i)
    np.testing.assert_allclose(got_v, want_v, rtol=rtol, atol=atol)
    for q in range(want_v.shape[0]):
        i, k = 0, want_v.shape[1]
        while i < k:
            j = i + 1
            while j < k and np.isclose(want_v[q, j], want_v[q, j - 1],
                                       rtol=rtol, atol=atol):
                j += 1
            assert sorted(got_i[q, i:j]) == sorted(want_i[q, i:j]), (q, i, j)
            i = j


def assert_stats_equal(got, want):
    for field in want.stats._fields:
        np.testing.assert_array_equal(getattr(got.stats, field).numpy(),
                                      np.asarray(getattr(want.stats, field)),
                                      err_msg=field)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _member(nlist=tmut.NLIST, seed=5):
    perm = np.random.default_rng(seed).permutation(nlist)
    m = np.zeros((3, nlist), bool)
    for t in range(3):
        m[t, perm[t::3]] = True
    return m


# ---------------------------------------------------------------------------
# partitioning and merging
# ---------------------------------------------------------------------------

def _store(nlist, cap, seed):
    rng = np.random.default_rng(seed)
    sizes = rng.integers(0, cap + 1, nlist).astype(np.int32)
    ids = np.full((nlist, cap), -1, np.int32)
    perm = rng.permutation(nlist * cap).astype(np.int32)
    for lst in range(nlist):
        ids[lst, :sizes[lst]] = perm[lst * cap:lst * cap + sizes[lst]]
    ids[ids >= 0] = np.where(rng.random((ids >= 0).sum()) < 0.1, -1,
                             ids[ids >= 0])          # a few tombstones
    return {"codes": rng.integers(0, 256, (nlist, cap, 4), np.uint8),
            "ids": ids, "sizes": sizes,
            "attrs": np.where(ids >= 0, ids % 7, -1).astype(np.int32)}


@pytest.mark.parametrize("nlist,s", [(16, 1), (16, 4), (13, 3), (10, 4),
                                     (7, 5)])
def test_partitions_are_bit_for_bit(nlist, s):
    arrays = _store(nlist, 12, seed=nlist * 10 + s)
    cen = np.random.default_rng(s).normal(size=(nlist, 6)).astype(np.float32)
    np.testing.assert_array_equal(tlists.round_robin_perm(nlist, s),
                                  jlists.round_robin_perm(nlist, s))
    jstore = jlists.store_from_arrays(arrays)
    wc, wl, wr = jlists.partition_lists(jstore, jnp.asarray(cen), s)
    gc, gl, gr = tlists.partition_lists(
        tlists.store_from_arrays(arrays, device="cpu"), _t(cen), s)
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
    np.testing.assert_array_equal(gr.numpy(), np.asarray(wr))
    for name in ("codes", "ids", "sizes", "attrs"):
        np.testing.assert_array_equal(getattr(gl, name).numpy(),
                                      np.asarray(getattr(wl, name)), name)
    assert gl.nlist == -(-nlist // s) and gl.cap == 12
    bits = np.random.default_rng(3).integers(0, 256, (nlist, 2), np.uint8)
    np.testing.assert_array_equal(
        tlists.partition_filter(_t(bits), s).numpy(),
        np.asarray(jlists.partition_filter(jnp.asarray(bits), s)))
    base = np.random.default_rng(4).normal(size=(nlist * 12, 6)).astype(
        np.float32)
    want = jlists.partition_base(wl, jnp.asarray(base))
    got = tlists.partition_base(gl, _t(base))
    for g, w, name in zip(got[:3], want[:3], ("base_s", "gids_s", "local")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), name)
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]),
                               rtol=1e-6)


@pytest.mark.parametrize("n,k,block", [(5000, 10, 1024), (3000, 40, 512),
                                       (900, 10, 256), (700, 10, 1024)])
def test_tournament_topk_is_bit_for_bit(n, k, block):
    # few distinct values: ties across and inside blocks
    d = np.random.default_rng(n).integers(0, 6, (4, n)).astype(np.float32)
    d[1, 100:] = np.inf
    wv, wi = jtopk.tournament_topk(jnp.asarray(d), k, block=block)
    gv, gi = ttopk.tournament_topk(_t(d), k, block=block)
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))


def test_the_merge_puts_ties_on_the_lowest_shard():
    """Equal distances on several shards: the merge lays the shards side by
    side in shard order, as the reference's all_gather(axis=1) does, so
    the lowest shard's ids come first; inside a shard, the lowest
    position."""
    s, q, k = 4, 3, 5
    rng = np.random.default_rng(9)
    vals = rng.integers(0, 3, (s, q, k)).astype(np.float32)
    vals.sort(axis=-1)
    ids = (np.arange(s)[:, None, None] * 100
           + np.arange(k)[None, None, :] + np.zeros((1, q, 1), int)
           ).astype(np.int32)
    wv, wi = jax.vmap(lambda v, i: jtopk.distributed_topk(v, i, k, "s"),
                      axis_name="s")(jnp.asarray(vals), jnp.asarray(ids))
    gv, gi = ttopk.merge_topk([_t(v) for v in vals], [_t(i) for i in ids], k)
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv[0]))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi[0]))
    # all equal: the first shard's k ids, in order
    flat = ttopk.merge_topk([torch.zeros(q, k)] * s, [_t(i) for i in ids], k)
    np.testing.assert_array_equal(flat[1].numpy(), ids[0])


# ---------------------------------------------------------------------------
# sharded search against the reference's vmap path
# ---------------------------------------------------------------------------

def _pair(cfg_name, s, *, namespaces=None, **extra):
    kw = dict(CONFIGS[cfg_name], **extra)
    cfg = EngineConfig(**kw)
    tsh = ShardedEngine(tmut.port_engine(cfg, attrs=True,
                                         namespaces=namespaces), s)
    jsh = JSharded(tmut.ref_engine(cfg, attrs=True, namespaces=namespaces),
                   s)
    return tsh, jsh


@functools.lru_cache(maxsize=None)
def _queries():
    ds, _ = tmut._built()
    return np.asarray(ds.queries)


@pytest.mark.parametrize("s", [1, 2, 3, 4])
@pytest.mark.parametrize("cfg_name", list(CONFIGS))
def test_sharded_search_matches_the_reference(cfg_name, s):
    tsh, jsh = _pair(cfg_name, s, namespaces=_member())
    q = _queries()
    cases = [({}, {})]
    store = tmut.ref_engine(EngineConfig(**CONFIGS[cfg_name]),
                            attrs=True).index.lists
    fb = np.asarray(jlists.filter_from_attrs(store, lambda a: a % 3 != 0))
    cases.append(({"filter_bits": fb}, {"filter_bits": jnp.asarray(fb)}))
    ns = np.array([-1, 0, 1, 2, 0, 7, -1, 1], np.int32)[:q.shape[0]]
    cases.append(({"namespaces": ns}, {"namespaces": jnp.asarray(ns)}))
    for tkw, jkw in cases:
        got = tsh.search(q, 10, **tkw)
        want = jsh.search(jnp.asarray(q), 10, **jkw)
        assert_tie_aware(got.dists, got.ids, want.dists, want.ids)
        assert_stats_equal(got, want)
        assert got.ids.dtype == torch.int32


@pytest.mark.parametrize("s", [1, 2, 3, 4])
def test_margin_tau_inf_is_fixed_and_matches_the_reference(s):
    q = _queries()
    tsh, jsh = _pair("stream", s, probe_policy="margin",
                     margin_tau=float("inf"), early_exit=True)
    fixed, _ = _pair("stream", s)
    got = tsh.search(q, 10)
    base = fixed.search(q, 10)
    assert torch.equal(got.ids, base.ids)
    assert torch.equal(got.dists, base.dists)
    want = jsh.search(jnp.asarray(q), 10)
    assert_tie_aware(got.dists, got.ids, want.dists, want.ids)
    assert_stats_equal(got, want)
    # a finite per-query tau prunes, and the reference prunes the same
    tau = np.linspace(0.0, 0.6, q.shape[0]).astype(np.float32)
    got = tsh.search(q, 10, margin_tau=tau)
    want = jsh.search(jnp.asarray(q), 10, margin_tau=jnp.asarray(tau))
    assert_tie_aware(got.dists, got.ids, want.dists, want.ids)
    assert_stats_equal(got, want)
    assert int(got.stats.lists_pruned.sum()) > 0


def test_one_shard_is_the_single_host_port_engine():
    """On the CPU one shard is the single-host port engine bit for bit: the
    same torch ops over the same rows (the partitioned base holds them in
    another order, which the eager ops do not see)."""
    q = _queries()
    for name in CONFIGS:
        cfg = EngineConfig(**CONFIGS[name])
        eng = tmut.port_engine(cfg)
        got = ShardedEngine(eng, 1).search(q, 10)
        want = eng.search(q, 10)
        assert torch.equal(got.ids, want.ids), name
        assert torch.equal(got.dists, want.dists), name
        for x, y in zip(got.stats, want.stats):
            assert torch.equal(x, y), name


def test_the_references_lut_build_rounds_otherwise_under_the_shard_axis():
    """Why the reference's ``test_sharded_single_shard_matches_unsharded``
    fails (rerank_mult=0, so no re-rank is involved): its vmap path
    traces ``scan_probes`` with a leading shard axis, and XLA compiles the
    LUT build for that shape with other f32 rounding. The u8 tables agree;
    some scales and biases move by an ulp, and with them the dequantized
    distances; ids agree."""
    _, index = tmut._built()
    q = jnp.asarray(_queries())
    probes = jtopk.smallest_k(
        jnp.sum((q[:, None] - index.centroids[None]) ** 2, -1), 8)[1]

    def tables(cen):
        return jivf._probe_tables(index._replace(centroids=cen), q, probes)
    plain = jax.jit(tables)(index.centroids)
    sharded = jax.jit(jax.vmap(tables))(index.centroids[None])
    np.testing.assert_array_equal(np.asarray(plain.table_q8),
                                  np.asarray(sharded.table_q8[0]))
    differ = (np.asarray(plain.scale) != np.asarray(sharded.scale[0])).sum()
    differ += (np.asarray(plain.bias) != np.asarray(sharded.bias[0])).sum()
    assert differ > 0
    np.testing.assert_allclose(np.asarray(sharded.scale[0]),
                               np.asarray(plain.scale), rtol=1e-6)


# ---------------------------------------------------------------------------
# mutation through the shards
# ---------------------------------------------------------------------------

def _program(eng, sh, model, rng):
    """The reference's sharded oracle program: 200 deletes, then 150 new
    rows (which overflow some lists)."""
    dead = rng.choice(tmut.N0, size=200, replace=False)
    assert sh.delete(dead) == eng.delete(dead) == dead.size
    model.delete(dead)
    new_ids = np.arange(tmut.N0, tmut.N0 + 150)
    new_vecs = rng.normal(size=(150, D)).astype(np.float32)
    np.testing.assert_array_equal(sh.upsert(new_ids, new_vecs),
                                  eng.upsert(new_ids, new_vecs))
    model.upsert(new_ids, new_vecs)
    return dead


@pytest.mark.parametrize("s", [2, 3])
@pytest.mark.parametrize("cfg_name", ["stream", "gathered"])
def test_sharded_mutation_matches_the_single_host_port_engine(cfg_name, s):
    """The program on a sharded engine and on a single-host one. Each shard
    probes nprobe of its own lists, so the oracle is the single-host engine
    after the same program, sharded afresh (the reference's oracle test
    with the single-host engine in place of a rebuild); with every list
    probed and no re-rank the two scan the same rows, and the single-host
    engine itself is the oracle. Tie-aware within the tolerance, no deleted
    id back; the reference's sharded engine after the same program agrees
    too, with exact stats. Then the same after compaction."""
    cfg = EngineConfig(**CONFIGS[cfg_name])
    ds, _ = tmut._built()
    eng = tmut.port_engine(cfg)
    sh = ShardedEngine(tmut.port_engine(cfg), s)
    jeng = tmut.ref_engine(cfg)
    jsh = JSharded(jeng, s)
    model = tmut.Model(np.asarray(ds.base))
    dead = _program(eng, sh, model, np.random.default_rng(21))
    _program(jeng, jsh, tmut.Model(np.asarray(ds.base)),
             np.random.default_rng(21))
    assert sh.epoch == 2 and sh.n_tombstones == jsh.n_tombstones == 200
    assert sh.cap == jsh.cap
    q = _queries()
    for stage in ("mutated", "compacted"):
        got = sh.search(q, 10)
        oracle = ShardedEngine(eng, s).search(q, 10)
        assert_tie_aware(got.dists, got.ids, oracle.dists, oracle.ids)
        assert not np.isin(got.ids.numpy(), dead).any(), stage
        every = sh.search(q, 10, nprobe=sh.lists_s.nlist, rerank_mult=0)
        single = eng.search(q, 10, nprobe=tmut.NLIST, rerank_mult=0)
        assert_tie_aware(every.dists, every.ids, single.dists, single.ids)
        want = jsh.search(jnp.asarray(q), 10)
        assert_tie_aware(got.dists, got.ids, want.dists, want.ids)
        assert_stats_equal(got, want)
        if stage == "mutated":
            assert (got.stats.rows_tombstoned.numpy() > 0).all()
            assert sh.compact() == jsh.compact() == 200
            assert sh.n_tombstones == 0 and sh.live_s is None
            np.testing.assert_array_equal(sh.gids_s.numpy(),
                                          np.asarray(jsh.gids_s))
            np.testing.assert_array_equal(sh.lists_s.ids.numpy(),
                                          np.asarray(jsh.lists_s.ids))


def test_the_single_host_engine_compacts_where_the_sharded_one_grows():
    """Why the reference's ``test_sharded_mutation_oracle_vmap`` fails: it
    asserts equal tombstone counts after an upsert that overflows a list.
    The single-host engine compacts before it grows (its 200 tombstones are
    gone and cap grows only to what the live rows need); the sharded
    engine grows cap over the tombstones and keeps them. Both still match
    their oracle. The port keeps both policies, with the same numbers."""
    cfg = EngineConfig(**CONFIGS["stream"])
    for s in (2, 3):
        jeng = tmut.ref_engine(cfg)
        jsh = JSharded(jeng, s)
        eng = tmut.port_engine(cfg)
        sh = ShardedEngine(tmut.port_engine(cfg), s)
        cap0 = jsh.cap
        _program(jeng, jsh, tmut.Model(np.zeros((tmut.N0, D))),
                 np.random.default_rng(21))
        _program(eng, sh, tmut.Model(np.zeros((tmut.N0, D))),
                 np.random.default_rng(21))
        assert jeng.n_tombstones == eng.n_tombstones == 0
        assert jsh.n_tombstones == sh.n_tombstones == 200
        assert jsh.cap == sh.cap > jeng.index.lists.cap > cap0
        assert eng.index.lists.cap == jeng.index.lists.cap


def test_locate_reupsert_growth_and_checks():
    cfg = EngineConfig(**CONFIGS["stream"])
    ds, _ = tmut._built()
    sh = ShardedEngine(tmut.port_engine(cfg), 3)
    jsh = JSharded(tmut.ref_engine(cfg), 3)
    loc = sh.locate(42)
    assert loc == jsh.locate(42)
    sh.delete([42])
    assert sh.locate(42) is None
    v = np.asarray(ds.base[42])[None, :]
    sh.upsert(np.array([42]), v)
    j, lst, _ = sh.locate(42)
    assert (j, lst) == loc[:2]
    res = sh.search(v, 1)
    assert int(res.ids[0, 0]) == 42 and float(res.dists[0, 0]) == 0.0
    # many rows past the base slices' headroom: R grows by 256-row steps
    r0 = sh.base_s.shape[1]
    new = np.random.default_rng(8).normal(size=(900, D)).astype(np.float32)
    sh.upsert(np.arange(5000, 5900), new * 64)
    assert sh.base_s.shape[1] > r0 and sh.base_s.shape[1] % 256 == 0
    assert sh.locate(5899) is not None
    with pytest.raises(ValueError, match="duplicate"):
        sh.upsert(np.array([1, 1]), np.zeros((2, D), np.float32))
    with pytest.raises(ValueError, match=">= 0"):
        sh.upsert(np.array([-1]), np.zeros((1, D), np.float32))
    # a WAL attaches and detaches: each write logs one record while on
    logged = []
    log = type("Log", (), {"log_delete": lambda self, ids: logged.append(
        sorted(int(i) for i in ids))})()
    sh.attach_wal(log)
    sh.delete(np.array([42, 7]))
    sh.attach_wal(None)
    sh.delete(np.array([8]))
    assert logged == [[7, 42]] and sh._wal is None
    with pytest.raises(ValueError, match="num_shards"):
        ShardedEngine(tmut.port_engine(cfg), 0)
    with pytest.raises(ValueError, match="too narrow"):
        sh.search(v, 1, filter_bits=np.zeros((tmut.NLIST, 1), np.uint8))


# ---------------------------------------------------------------------------
# the torch.distributed path
# ---------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def test_the_process_group_path_equals_the_in_turn_path():
    """Two gloo ranks on the CPU, each running its shard: bit for bit the
    in-turn path's results, before and after mutation
    (``tests/_torch_dist_harness.py``)."""
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(_HARNESS), str(rank), "2",
                               str(port)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for rank in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0 and out.strip().endswith("OK"), (
            f"rank failed\nstdout:\n{out}\nstderr:\n{err[-3000:]}")

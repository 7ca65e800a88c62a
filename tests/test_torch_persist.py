"""The port's durable index (``repro_torch.persist``) held against the
reference's on the CPU.

- **WAL bytes.** The same records give the same bytes from both packages'
  writers (file headers with their terms, records, rotation), and a WAL
  written by either package replays in the other. Torn tails, chain gaps,
  the rotation seam, duplicate seqs and file-header terms read the same
  whichever package wrote the log and whichever reads it.
- **Cross-open.** A snapshot + WAL directory that ``repro`` wrote opens in
  ``repro_torch`` on the CPU and the other way round: flat, HNSW and tree
  coarse, filtered and namespaced, tombstoned (the snapshot holds
  tombstones and the WAL adds more), and sharded at S = 2. The stores are
  bit for bit equal, ids tie-aware, distances within f32 tolerance, all
  seven ``QueryStats`` exact.
- **Recovery in the port** is bit for bit (dists, ids, stats, epoch), and
  a crash at every mutation step and every checkpoint step, a bit flip in
  every file and a short read at every step give an acknowledged prefix or
  a typed error (``tests/_torch_faults.py`` patches the port's I/O seam).
  Delta snapshots reuse segments, GC keeps the reachable chain, and a
  schema-1 manifest migrates.
- **Durable before visible.** A WAL append that fails (fenced, or an I/O
  error) leaves both port engines as they were: store, base, norms, live
  bits, epoch, tombstones, locator and search results.

Every engine starts from the index ``tests/test_persist.py`` builds with
``repro``, carried over as numpy arrays; new rows come from numpy seeds.
"""
import functools
import json
import os
import pathlib
import shutil
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).parent))
import _torch_faults as tfaults  # noqa: E402
import test_persist as jp  # noqa: E402  (the reference's index and ops)

from repro import persist as jpersist  # noqa: E402
from repro.core import lists as jlists  # noqa: E402
from repro.engine import EngineConfig as JConfig  # noqa: E402
from repro.engine import SearchEngine as JEngine  # noqa: E402
from repro.engine import ShardedEngine as JSharded  # noqa: E402
from repro.persist import wal as jwal  # noqa: E402
from repro_torch import interop, persist  # noqa: E402
from repro_torch.core import lists as tlists  # noqa: E402
from repro_torch.engine import (EngineConfig, SearchEngine,  # noqa: E402
                                ShardedEngine)
from repro_torch.persist import io as tpio  # noqa: E402
from repro_torch.persist import wal as twal  # noqa: E402
from repro_torch.persist.snapshot import _manifest_crc  # noqa: E402

D, NLIST = jp.D, jp.NLIST
HNSW_M, EF_C = 4, 16   # 2·m < nlist: no padded level-0 row (ROADMAP Queue 3)
RTOL = 1e-5
CFG = dict(nprobe=6, rerank_mult=2)
PKGS = {"repro": (jpersist, jwal), "repro_torch": (persist, twal)}


# ---------------------------------------------------------------------------
# engines over the reference's index
# ---------------------------------------------------------------------------

def _ref_arrays(attrs: bool = False) -> dict:
    ds, index = jp._built()
    out = dict(jlists.store_arrays(index.lists))
    if attrs:
        out["attrs"] = np.where(out["ids"] >= 0,
                                jp._attr_of(np.maximum(out["ids"], 0)),
                                -1).astype(np.int32)
    out["centroids"] = np.asarray(index.centroids)
    out["codebook"] = np.asarray(index.codebook.codewords)
    out["base"] = np.array(ds.base, np.float32)
    return out


def port_engine(cfg: EngineConfig | None = None, *, attrs=False,
                namespaces=None, coarse="flat") -> SearchEngine:
    a = _ref_arrays(attrs)
    return SearchEngine(interop.index_from_arrays(a, "cpu"),
                        base=torch.from_numpy(a["base"]), coarse=coarse,
                        config=cfg or EngineConfig(**CFG),
                        namespaces=namespaces, hnsw_m=HNSW_M,
                        ef_construction=EF_C)


def ref_engine(cfg: EngineConfig | None = None, *, attrs=False,
               namespaces=None, coarse="flat"):
    a = _ref_arrays(attrs)
    _, index = jp._built()
    store = jlists.store_from_arrays(
        {k: a[k] for k in ("codes", "ids", "sizes", "attrs") if k in a})
    return JEngine(index._replace(lists=store), base=jnp.asarray(a["base"]),
                   coarse=coarse,
                   config=JConfig(**(cfg or EngineConfig(**CFG))._asdict()),
                   namespaces=None if namespaces is None
                   else jnp.asarray(namespaces),
                   hnsw_m=HNSW_M, ef_construction=EF_C)


def _queries() -> np.ndarray:
    return np.array(jp._built()[0].queries, np.float32)


def _np(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@functools.lru_cache(maxsize=None)
def _atol() -> float:
    """1e-6 x (max ||q||^2 + max ||x||^2): the norms + GEMM distance's
    rounding, which each framework does its own way."""
    q, x = _queries(), _ref_arrays()["base"]
    return 1e-6 * float((q * q).sum(1).max() + (x * x).sum(1).max())


def assert_tie_aware(got, want):
    """ids equal up to order inside runs of near-equal distances, distances
    within f32 tolerance, every QueryStats field exact."""
    gv, gi, wv, wi = (_np(got.dists), _np(got.ids), _np(want.dists),
                      _np(want.ids))
    np.testing.assert_allclose(gv, wv, rtol=RTOL, atol=_atol())
    for q in range(wv.shape[0]):
        i, k = 0, wv.shape[1]
        while i < k:
            j = i + 1
            while j < k and np.isclose(wv[q, j], wv[q, j - 1], rtol=RTOL,
                                       atol=_atol()):
                j += 1
            assert sorted(gi[q, i:j]) == sorted(wi[q, i:j]), (q, i, j)
            i = j
    for field in want.stats._fields:
        np.testing.assert_array_equal(_np(getattr(got.stats, field)),
                                      _np(getattr(want.stats, field)),
                                      err_msg=field)


def assert_same_results(a, b, q, *, k=8, calls=("search", "search_jit"),
                        **kw):
    """Port engines: dists, ids and every stat bit for bit."""
    for call in calls:
        ra, rb = getattr(a, call)(q, k, **kw), getattr(b, call)(q, k, **kw)
        for x, y in zip((ra.dists, ra.ids, *ra.stats),
                        (rb.dists, rb.ids, *rb.stats)):
            assert torch.equal(x, y), call


def apply_ops(eng, ops, attrs=False):
    for op in ops:
        if op[0] == "upsert":
            eng.upsert(op[1], op[2],
                       attrs=jp._attr_of(op[1]) if attrs else None)
        elif op[0] == "delete":
            eng.delete(op[1])
        else:
            eng.compact()


def _fresh_durable(tmp_path, name, **kw):
    d = str(tmp_path / name)
    eng = port_engine(**kw)
    persist.ensure_attached(eng, d)
    return eng, d


def _open(d, **kw):
    return persist.open_engine(d, device="cpu", **kw)


# ---------------------------------------------------------------------------
# the WAL: the same bytes, either package's log in the other
# ---------------------------------------------------------------------------

def _write_log(pkg, d, term):
    _p, wal = PKGS[pkg]
    rng = np.random.default_rng(3)
    w = wal.WALWriter(os.path.join(d, wal.wal_name(1)), 1, term=term)
    w.log_upsert(np.arange(5), rng.normal(size=(5, D)))
    w.log_upsert(np.array([9]), rng.normal(size=(1, D)),
                 attrs=np.array([4]))
    w.log_delete(np.array([7, 3]))
    w.rotate(d)
    w.log_compact(None)
    w.log_compact(5120)
    w.rotate(d)
    w.log_delete(np.array([1]))
    w.close()


@pytest.mark.parametrize("term", [0, 7])
def test_wal_bytes_are_the_references(tmp_path, term):
    for pkg in PKGS:
        os.makedirs(tmp_path / pkg)
        _write_log(pkg, str(tmp_path / pkg), term)
    names = sorted(os.listdir(tmp_path / "repro"))
    assert names == sorted(os.listdir(tmp_path / "repro_torch"))
    assert names == [jwal.wal_name(s) for s in (1, 4, 6)]
    for name in names:
        want = (tmp_path / "repro" / name).read_bytes()
        assert (tmp_path / "repro_torch" / name).read_bytes() == want, name
        assert twal.wal_term(str(tmp_path / "repro" / name)) == term
    assert [r.seq for r in twal.iter_wal(str(tmp_path / "repro"))] == list(
        range(1, 7))


@pytest.mark.parametrize("writer,reader", [("repro", "repro_torch"),
                                           ("repro_torch", "repro")])
def test_a_wal_from_either_package_replays_in_the_other(tmp_path, writer,
                                                        reader):
    """Engine A logs the scripted mutations; B's ``iter_wal`` +
    ``apply_record`` replay them into B's engine, which then equals B's
    engine that ran the mutations itself."""
    make = {"repro": lambda: ref_engine(), "repro_torch": port_engine}
    ops = jp.scripted_ops(7)
    d = str(tmp_path / "d")
    a = make[writer]()
    PKGS[writer][0].ensure_attached(a, d)
    apply_ops(a, ops)
    _rp, rwal = PKGS[reader]
    replayed, direct = make[reader](), make[reader]()
    recs = list(rwal.iter_wal(d))
    assert [r.op for r in recs] == [op[0] for op in ops]
    for rec in recs:
        rwal.apply_record(replayed, rec)
    apply_ops(direct, ops)
    q = _queries()
    for call in ("search", "search_jit")[:2 if reader == "repro_torch" else 1]:
        x, y = getattr(replayed, call)(q, 8), getattr(direct, call)(q, 8)
        np.testing.assert_array_equal(_np(x.ids), _np(y.ids), err_msg=call)
        np.testing.assert_array_equal(_np(x.dists), _np(y.dists))
    assert replayed.epoch == direct.epoch
    # and the readers agree on the writer's records array for array
    other = [r for r in PKGS[writer][1].iter_wal(d)]
    for r1, r2 in zip(recs, other):
        assert (r1.seq, r1.op, sorted(r1.arrays)) == (r2.seq, r2.op,
                                                      sorted(r2.arrays))
        for key in r1.arrays:
            np.testing.assert_array_equal(r1.arrays[key], r2.arrays[key])


PAIRS = [("repro", "repro_torch"), ("repro_torch", "repro"),
         ("repro_torch", "repro_torch")]


@pytest.mark.parametrize("writer,reader", PAIRS)
def test_torn_tails_gaps_and_flips_read_alike(tmp_path, writer, reader):
    wp, ww = PKGS[writer]
    rp, rw = PKGS[reader]
    p = str(tmp_path / ww.wal_name(1))
    w = ww.WALWriter(p, 1)
    w.log_upsert(np.array([1, 2]), np.ones((2, 4), np.float32))
    w.log_delete(np.array([7]))
    w.log_compact(None)
    w.close()
    recs, _valid, clean = rw.scan_wal(p)
    assert clean and [r.op for r in recs] == ["upsert", "delete", "compact"]
    tfaults.truncate_file(p, fraction=0.9)
    recs, _valid, clean = rw.scan_wal(p)
    assert not clean and [r.op for r in recs] == ["upsert", "delete"]
    p2 = str(tmp_path / "flip" / ww.wal_name(10))
    os.makedirs(os.path.dirname(p2))
    w = ww.WALWriter(p2, 10)
    w.log_delete(np.array([1]))
    w.log_delete(np.array([2]))
    w.close()
    tfaults.flip_byte_in(p2, offset=30)  # inside record 1's preamble
    with pytest.raises(rp.CorruptWALError):
        rw.scan_wal(p2)
    # a chain gap and a torn non-final file are loud
    d = str(tmp_path / "chain")
    os.makedirs(d)
    w = ww.WALWriter(os.path.join(d, ww.wal_name(1)), 1)
    w.log_delete(np.array([1]))
    w.log_delete(np.array([2]))
    w.close()
    w = ww.WALWriter(os.path.join(d, ww.wal_name(3)), 3)
    w.log_delete(np.array([3]))
    w.close()
    assert [r.seq for r in rw.iter_wal(d)] == [1, 2, 3]
    tfaults.truncate_file(os.path.join(d, ww.wal_name(1)), 0.5)
    with pytest.raises(rp.CorruptWALError):
        list(rw.iter_wal(d))
    os.remove(os.path.join(d, ww.wal_name(1)))
    with pytest.raises(rp.CorruptWALError):
        list(rw.iter_wal(d))


@pytest.mark.parametrize("writer,reader", PAIRS)
def test_the_rotation_seam_and_duplicate_seqs_read_alike(tmp_path, writer,
                                                         reader):
    _wp, ww = PKGS[writer]
    rp, rw = PKGS[reader]
    d = str(tmp_path / "seam")
    os.makedirs(d)
    w = ww.WALWriter(os.path.join(d, ww.wal_name(1)), 1)
    w.log_delete(np.array([1]))
    w.log_delete(np.array([2]))
    w.rotate(d)
    w.log_delete(np.array([3]))
    w.log_delete(np.array([4]))
    w.close()
    for after, want in ((0, [1, 2, 3, 4]), (2, [3, 4]), (3, [4]), (4, []),
                        (99, [])):
        assert [r.seq for r in rw.iter_wal(d, after_seq=after)] == want
    d = str(tmp_path / "dup")
    os.makedirs(d)
    w = ww.WALWriter(os.path.join(d, ww.wal_name(1)), 1)
    w.log_delete(np.array([1]))
    w.log_delete(np.array([2]))
    w.close()
    with open(os.path.join(d, ww.wal_name(2)), "wb") as f:
        for seq in (2, 3):
            f.write(ww.encode_record(seq, "delete",
                                     {"ids": np.array([seq], np.int64)}))
    assert [r.seq for r in rw.iter_wal(d, after_seq=2)] == [3]
    with pytest.raises(rp.CorruptWALError, match="gap|order"):
        list(rw.iter_wal(d, after_seq=0))


@pytest.mark.parametrize("writer,reader", PAIRS)
def test_file_header_terms_read_alike(tmp_path, writer, reader):
    _wp, ww = PKGS[writer]
    rp, rw = PKGS[reader]
    p = str(tmp_path / ww.wal_name(1))
    w = ww.WALWriter(p, 1, term=7)
    w.log_delete(np.array([1]))
    w.close()
    assert rw.wal_term(p) == 7
    legacy = str(tmp_path / ww.wal_name(2))
    with open(legacy, "wb") as f:  # headerless (pre-replication) format
        f.write(ww.encode_record(2, "delete",
                                 {"ids": np.array([2], np.int64)}))
    assert rw.wal_term(legacy) == 0
    assert [r.seq for r in rw.iter_wal(str(tmp_path))] == [1, 2]
    torn = str(tmp_path / ww.wal_name(3))
    with open(torn, "wb") as f:
        f.write(ww.encode_file_header(1, 3)[:10])
    recs, valid, clean = rw.scan_wal(torn)
    assert recs == [] and valid == 0 and not clean
    bad = str(tmp_path / "wal-000000000099.log")
    with open(bad, "wb") as f:
        f.write(ww.encode_file_header(1, 99))
    tfaults.flip_byte_in(bad, offset=5)
    with pytest.raises(rp.CorruptWALError):
        rw.scan_wal(bad)


# ---------------------------------------------------------------------------
# snapshots open across the packages, both ways
# ---------------------------------------------------------------------------

def _member():
    perm = np.random.default_rng(5).permutation(NLIST)
    ns = np.zeros((3, NLIST), bool)
    for t in range(3):
        ns[t, perm[t::3]] = True
    return ns


CASES = {
    "flat": dict(),
    "hnsw": dict(coarse="hnsw"),
    "tree": dict(coarse="tree"),
    "filtered_namespaced": dict(attrs=True, namespaces=_member()),
    "sharded": dict(shards=2),
}


def _case_engine(pkg, case):
    kw = dict(CASES[case])
    shards = kw.pop("shards", None)
    eng = (ref_engine if pkg == "repro" else port_engine)(**kw)
    if shards:
        eng = (JSharded if pkg == "repro" else ShardedEngine)(eng, shards)
    return eng


def _search(eng, case, q):
    kw = {}
    if case == "filtered_namespaced":
        if isinstance(eng, JEngine):
            kw["filter_bits"] = jlists.filter_from_attrs(
                eng.index.lists, lambda a: a % 5 != 1)
        else:
            kw["filter_bits"] = tlists.filter_from_attrs(
                eng.index.lists, lambda a: a % 5 != 1)
        kw["namespaces"] = np.array([0, 1, 2, 0, -1, 1], np.int32)[
            :q.shape[0]]
    return eng.search(jnp.asarray(q) if not isinstance(
        eng, (SearchEngine, ShardedEngine)) else q, 8, **kw)


def _stores(eng) -> dict:
    if isinstance(eng, ShardedEngine):
        out = tlists.store_arrays(eng.lists_s)
        out["gids"] = eng.gids_s.numpy()
        return out
    if isinstance(eng, JSharded):
        out = jlists.store_arrays(eng.lists_s)
        out["gids"] = np.asarray(eng.gids_s)
        return out
    if isinstance(eng, SearchEngine):
        return tlists.store_arrays(eng.index.lists)
    return jlists.store_arrays(eng.index.lists)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("writer", ["repro", "repro_torch"])
def test_a_snapshot_opens_across_packages(tmp_path, writer, case):
    """A writes a snapshot holding tombstones, then logs more writes and a
    compaction; B opens the directory (snapshot + WAL replay) and equals
    A's live engine."""
    reader = "repro_torch" if writer == "repro" else "repro"
    attrs = CASES[case].get("attrs", False)
    ops = jp.scripted_ops(7)
    d = str(tmp_path / "d")
    a = _case_engine(writer, case)
    if case == "hnsw" and writer == "repro_torch":
        assert (a.coarse.graph.level0.numpy() >= 0).all()  # no padded row
    wp, _ = PKGS[writer]
    wp.ensure_attached(a, d)
    apply_ops(a, ops[:3], attrs)
    manifest = wp.save_snapshot(a, d)
    assert manifest["meta"]["n_tombstones"] > 0
    apply_ops(a, ops[3:], attrs)
    rp, _ = PKGS[reader]
    kw = {"device": "cpu"} if reader == "repro_torch" else {}
    b, info = rp.open_engine(d, attach=False, **kw)
    assert info.replayed == len(ops) - 3 and info.wal_seq == 3
    assert type(b).__name__ == type(a).__name__
    assert (b.epoch, b.n_tombstones) == (a.epoch, a.n_tombstones)
    sa, sb = _stores(a), _stores(b)
    assert sorted(sa) == sorted(sb)
    for key in sa:
        np.testing.assert_array_equal(sb[key], sa[key], err_msg=key)
    q = _queries()
    assert_tie_aware(_search(b, case, q), _search(a, case, q))
    if case in ("hnsw", "tree"):
        assert getattr(b, "coarse_kind") == case


def test_the_port_restores_the_coarse_quantizer_it_saved(tmp_path):
    """The port writes its HNSW graph and tree as segments and prefers them
    on load, so its own recovery keeps the very quantizer it saved."""
    for coarse in ("hnsw", "tree"):
        eng, d = _fresh_durable(tmp_path, coarse, coarse=coarse)
        rec, _ = _open(d, attach=False)
        want = interop.arrays_from_coarse(eng.coarse)
        got = interop.arrays_from_coarse(rec.coarse)
        assert sorted(got) == sorted(want) and want
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        assert_same_results(eng, rec, _queries())


# ---------------------------------------------------------------------------
# recovery in the port, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scan_impl,rerank_impl", [
    ("ref", "gathered"), ("select", "gathered"), ("mxu", "stream"),
    ("stream", "stream")])
def test_recovery_is_bit_for_bit(tmp_path, scan_impl, rerank_impl):
    cfg = EngineConfig(nprobe=6, rerank_mult=2, scan_impl=scan_impl,
                       rerank_impl=rerank_impl)
    eng, d = _fresh_durable(tmp_path, "d", cfg=cfg)
    apply_ops(eng, jp.scripted_ops())
    rec, info = _open(d, attach=False)
    assert info.replayed == 6 and info.truncated_bytes == 0
    assert (rec.epoch, rec.n_tombstones) == (eng.epoch, eng.n_tombstones)
    assert rec.config == cfg
    assert_same_results(eng, rec, _queries())


def test_recovery_filtered_and_namespaced_is_bit_for_bit(tmp_path):
    eng, d = _fresh_durable(tmp_path, "d", attrs=True,
                            namespaces=_member())
    apply_ops(eng, jp.scripted_ops(), attrs=True)
    rec, _ = _open(d, attach=False)
    fb = tlists.filter_from_attrs(eng.index.lists, lambda a: a % 5 != 1)
    assert torch.equal(fb, tlists.filter_from_attrs(rec.index.lists,
                                                    lambda a: a % 5 != 1))
    assert_same_results(eng, rec, _queries(), filter_bits=fb,
                        namespaces=np.array([0, 1, 2, 0, 1, -1], np.int32))


def test_sharded_recovery_is_bit_for_bit(tmp_path):
    sh = ShardedEngine(port_engine(), 2)
    d = str(tmp_path / "d")
    persist.ensure_attached(sh, d)
    apply_ops(sh, jp.scripted_ops(5))
    persist.save_snapshot(sh, d)
    apply_ops(sh, jp.scripted_ops(7)[5:])
    rec, info = _open(d, attach=False)
    assert isinstance(rec, ShardedEngine) and info.replayed == 2
    assert (rec.epoch, rec.n_tombstones, rec.cap) == (sh.epoch,
                                                     sh.n_tombstones, sh.cap)
    assert_same_results(sh, rec, _queries(), calls=("search",))
    # and it keeps taking writes as the live one does
    for e in (sh, rec):
        e.upsert(np.array([7000, 3]), np.ones((2, D), np.float32))
    assert_same_results(sh, rec, _queries(), calls=("search",))


def test_recovered_engine_stays_durable(tmp_path):
    eng, d = _fresh_durable(tmp_path, "d")
    apply_ops(eng, jp.scripted_ops(3))
    rec, info = _open(d)
    assert rec._wal is not None and rec._wal.last_seq == info.last_seq
    apply_ops(rec, jp.scripted_ops(2, seed=23))
    rec2, info2 = _open(d, attach=False)
    assert info2.last_seq == info.last_seq + 2
    assert_same_results(rec, rec2, _queries())


def test_open_engine_wants_a_card_unless_asked(tmp_path, monkeypatch):
    eng, d = _fresh_durable(tmp_path, "d")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        persist.open_engine(d, attach=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        persist.load_snapshot(d)


# ---------------------------------------------------------------------------
# crash safety: prefix or loud
# ---------------------------------------------------------------------------

def _prefix_references(ops, q, k=8):
    eng = port_engine()
    refs = []
    for i in range(len(ops) + 1):
        r = eng.search(q, k)
        refs.append((r.dists.clone(), r.ids.clone()))
        if i < len(ops):
            apply_ops(eng, ops[i:i + 1])
    return refs


def _matches_some_prefix(engine, refs, q, k=8):
    r = engine.search(q, k)
    return any(torch.equal(r.dists, rd) and torch.equal(r.ids, ri)
               for rd, ri in refs)


def test_kill_at_every_mutation_step_recovers_prefix(tmp_path):
    ops = jp.scripted_ops(5)
    q = _queries()
    refs = _prefix_references(ops, q)
    for k in range(1, len(ops) + 1):
        eng, d = _fresh_durable(tmp_path, f"mut{k}")
        before = eng.search(q, 8)
        with tfaults.FaultInjector(crash_at_write=k, torn_fraction=0.6):
            with pytest.raises(tfaults.SimulatedCrash):
                apply_ops(eng, ops)
        # the op whose append crashed never became visible
        want = refs[k - 1] if k > 1 else (before.dists, before.ids)
        live = eng.search(q, 8)
        assert torch.equal(live.dists, want[0]), k
        rec, info = _open(d, attach=False)
        assert info.last_seq == k - 1 and info.truncated_bytes > 0
        r = rec.search(q, 8)
        assert torch.equal(r.dists, refs[k - 1][0]), k
        assert torch.equal(r.ids, refs[k - 1][1]), k


def test_crash_at_every_checkpoint_step_keeps_old_state(tmp_path):
    ops = jp.scripted_ops(4)
    eng, d = _fresh_durable(tmp_path, "count")
    apply_ops(eng, ops)
    with tfaults.FaultInjector() as counter:
        persist.save_snapshot(eng, d)
    assert counter.writes >= 5
    q = _queries()
    want = eng.search(q, 8)
    for n in range(1, counter.writes + 1):
        eng_n, d_n = _fresh_durable(tmp_path, f"ck{n}")
        apply_ops(eng_n, ops)
        with tfaults.FaultInjector(crash_at_write=n):
            with pytest.raises(tfaults.SimulatedCrash):
                persist.save_snapshot(eng_n, d_n)
        rec, info = _open(d_n, attach=False)
        assert info.last_seq == len(ops), n
        r = rec.search(q, 8)
        assert torch.equal(r.dists, want.dists) and torch.equal(r.ids,
                                                                want.ids), n


def test_bitflips_and_missing_files_are_typed(tmp_path):
    eng, d = _fresh_durable(tmp_path, "flip")
    apply_ops(eng, jp.scripted_ops(3))
    persist.save_snapshot(eng, d)
    apply_ops(eng, jp.scripted_ops(5)[3:])
    targets = tfaults.snapshot_files(d) + [os.path.join(d,
                                                        persist.MANIFEST_NAME)]
    for i, path in enumerate(targets):
        shutil.copyfile(path, path + ".orig")
        tfaults.flip_byte_in(path, seed=i)
        with pytest.raises(persist.CorruptSnapshotError):
            _open(d, attach=False)
        os.replace(path + ".orig", path)
    for path in tfaults.wal_paths(d):
        if os.path.getsize(path) <= 64:
            continue
        shutil.copyfile(path, path + ".orig")
        tfaults.flip_byte_in(path, offset=40)  # inside the first record
        with pytest.raises(persist.CorruptWALError):
            _open(d, attach=False)
        os.replace(path + ".orig", path)
    seg = tfaults.snapshot_files(d)[0]
    os.replace(seg, seg + ".orig")
    with pytest.raises(persist.CorruptSnapshotError):
        _open(d, attach=False)
    os.replace(seg + ".orig", seg)
    man = os.path.join(d, persist.MANIFEST_NAME)
    os.replace(man, man + ".orig")
    with pytest.raises(persist.NoSnapshotError):
        _open(d, attach=False)
    os.replace(man + ".orig", man)
    rec, _ = _open(d, attach=False)
    assert_same_results(eng, rec, _queries(), calls=("search",))


def test_short_read_prefix_or_loud(tmp_path):
    ops = jp.scripted_ops(4)
    eng, d = _fresh_durable(tmp_path, "short")
    apply_ops(eng, ops[:2])
    persist.save_snapshot(eng, d)
    apply_ops(eng, ops[2:])
    q = _queries()
    refs = _prefix_references(ops, q)
    with tfaults.FaultInjector() as counter:
        _open(d, attach=False)
    loud = 0
    for n in range(1, counter.reads + 1):
        with tfaults.FaultInjector(short_read_at=n):
            try:
                rec, _ = _open(d, attach=False)
            except (persist.CorruptSnapshotError, persist.CorruptWALError,
                    persist.NoSnapshotError):
                loud += 1
                continue
        assert _matches_some_prefix(rec, refs, q), f"short read {n}"
    assert loud > 0


# ---------------------------------------------------------------------------
# delta snapshots, GC, schema-1 manifests, group commit
# ---------------------------------------------------------------------------

def test_delta_snapshots_reuse_segments_and_gc_keeps_the_chain(tmp_path):
    eng, d = _fresh_durable(tmp_path, "d")
    m1 = persist.read_manifest(d)
    assert m1["parent"] is None and m1["delta"]["segments_reused"] == 0
    assert m1["delta"]["capture_s"] >= 0.0
    for i in range(3):  # delete-only deltas
        eng.delete(np.arange(200 + 20 * i, 210 + 20 * i))
        m = persist.save_snapshot(eng, d)
        assert m["parent"] is not None
        assert m["delta"]["segments_reused"] >= 3
        assert m["delta"]["bytes_reused"] > m["delta"]["bytes_written"]
    snaps = sorted(n for n in os.listdir(d) if n.startswith("snap-"))
    assert "snap-000001" in snaps and len(snaps) <= 3
    assert "snap-000002" not in snaps and "snap-000003" not in snaps
    eng.compact()
    m = persist.save_snapshot(eng, d)
    written = {k for k, e in m["segments"].items()
               if e["file"].startswith(m["snapshot"])}
    assert {"codes", "ids", "sizes"} <= written
    from_parent = {k for k, e in m["segments"].items()
                   if e["file"].startswith("snap-000001")}
    assert {"centroids", "codebook", "base"} <= from_parent
    rec, _ = _open(d, attach=False)
    assert_same_results(eng, rec, _queries())


def test_schema1_manifest_migrates(tmp_path):
    eng, d = _fresh_durable(tmp_path, "d")
    apply_ops(eng, jp.scripted_ops(2))
    persist.save_snapshot(eng, d)
    path = os.path.join(d, persist.MANIFEST_NAME)
    manifest = json.loads(tpio.read_bytes(path).decode("utf-8"))
    for k in ("term", "parent", "delta"):
        manifest.pop(k, None)
    manifest["schema"] = 1
    del manifest["manifest_crc"]
    manifest["manifest_crc"] = _manifest_crc(manifest)
    tpio.atomic_write_bytes(path, json.dumps(manifest).encode("utf-8"))
    back = persist.read_manifest(d)
    assert back["term"] == 0 and back["parent"] is None
    rec, info = _open(d, attach=False)
    assert info.term == 0
    assert_same_results(eng, rec, _queries())


def test_group_commit_flushes_on_rotate_and_recovers(tmp_path):
    eng, d = _fresh_durable(tmp_path, "d")
    eng._wal.close()
    eng.attach_wal(persist.WALWriter(eng._wal.path, eng._wal.last_seq + 1,
                                     fsync_interval=3600.0))
    apply_ops(eng, jp.scripted_ops(4))
    assert eng._wal._pending_fsync == 4
    eng._wal.rotate(d)
    assert eng._wal._pending_fsync == 0
    rec, info = _open(d, attach=False)
    assert info.last_seq == 4
    assert_same_results(eng, rec, _queries())


def test_foreign_directory_and_custom_coarse_are_refused(tmp_path):
    _eng, d = _fresh_durable(tmp_path, "own")
    with pytest.raises(ValueError, match="open_engine"):
        persist.ensure_attached(port_engine(), d)

    class Custom:
        def search(self, q, nprobe):
            raise NotImplementedError

    custom = SearchEngine(port_engine().index, coarse=Custom())
    with pytest.raises(ValueError, match="custom"):
        persist.save_snapshot(custom, str(tmp_path / "custom"))


# ---------------------------------------------------------------------------
# durable before visible, on both engines
# ---------------------------------------------------------------------------

def _state_of(eng) -> dict:
    """Every array a write could touch, the counters and a locator probe."""
    if isinstance(eng, ShardedEngine):
        st = eng._state
        out = {f"lists.{k}": v for k, v in
               tlists.store_arrays(st.lists_s).items()}
        out.update(base=st.base_s.numpy().copy(),
                   norms=st.norms_s.numpy().copy(),
                   gids=st.gids_s.numpy().copy(),
                   live=None if st.live_s is None else st.live_s.numpy().copy(),
                   rows_used=np.array(st.rows_used))
    else:
        out = {f"lists.{k}": v for k, v in
               tlists.store_arrays(eng.index.lists).items()}
        out.update(base=eng.base.numpy().copy(),
                   norms=eng.base_norms.numpy().copy(),
                   live=(None if eng.live_bits is None
                         else eng.live_bits.numpy().copy()))
    out["counters"] = np.array([eng.epoch, eng.n_tombstones])
    out["locate"] = np.array([-2 if eng.locate(g) is None else
                              sum(eng.locate(g)) for g in (3, 5, 700, 2001)])
    return out


def _failing_ops():
    rng = np.random.default_rng(41)
    return {
        "upsert_new": lambda e: e.upsert(np.arange(2000, 2010),
                                         rng.normal(size=(10, D))),
        "upsert_again": lambda e: e.upsert(np.array([3, 700]),
                                           rng.normal(size=(2, D))),
        "delete": lambda e: e.delete(np.array([5, 700, 9999])),
        "compact": lambda e: e.compact(),
        "compact_cap": lambda e: e.compact(cap=e.cap if isinstance(
            e, ShardedEngine) else e.index.lists.cap + 8),
    }


@pytest.mark.parametrize("failure", ["fenced", "io"])
@pytest.mark.parametrize("kind", ["single", "sharded"])
def test_a_failed_append_leaves_the_engine_unchanged(tmp_path, kind,
                                                     failure):
    eng = port_engine()
    if kind == "sharded":
        eng = ShardedEngine(eng, 2)
    d = str(tmp_path / "d")
    persist.ensure_attached(eng, d)
    eng.delete(np.arange(0, 4))  # tombstones, so compaction has work
    q = _queries()
    for name, op in _failing_ops().items():
        before = _state_of(eng)
        res0 = eng.search(q, 8)
        seq0 = eng._wal.last_seq
        if failure == "fenced":
            transport = persist.PipeTransport()
            transport.bump_term(1, start_seq=seq0 + 1)
            eng._wal.guard = persist.make_fence_guard(transport, 0)
            with pytest.raises(persist.FencedError):
                op(eng)
            eng._wal.guard = None
        else:
            def broken(f, data):
                raise OSError("disk full")
            orig = tpio.append_record
            tpio.append_record = broken
            try:
                with pytest.raises(OSError, match="disk full"):
                    op(eng)
            finally:
                tpio.append_record = orig
        after = _state_of(eng)
        for key in before:
            if before[key] is None:
                assert after[key] is None, (name, key)
            else:
                np.testing.assert_array_equal(after[key], before[key],
                                              err_msg=f"{name}: {key}")
        res = eng.search(q, 8)
        assert torch.equal(res.ids, res0.ids) and torch.equal(res.dists,
                                                              res0.dists)
        assert eng._wal.last_seq == seq0, name
    # a refused compaction logs nothing; the engine still takes writes and
    # recovers to exactly them
    with pytest.raises(ValueError, match="below the largest live list"):
        eng.compact(cap=1)
    seq = eng._wal.last_seq
    _failing_ops()["upsert_new"](eng)
    assert eng._wal.last_seq == seq + 1
    rec, _ = _open(d, attach=False)
    assert_same_results(eng, rec, q, calls=("search",))


def test_attach_and_detach_wal_on_both_engines(tmp_path):
    for kind, eng in (("single", port_engine()),
                      ("sharded", ShardedEngine(port_engine(), 2))):
        w = persist.WALWriter(str(tmp_path / f"{kind}.log"), 1)
        eng.attach_wal(w)
        eng.delete(np.array([1, 2]))
        eng.attach_wal(None)
        eng.delete(np.array([3]))
        w.close()
        recs, _v, clean = twal.scan_wal(str(tmp_path / f"{kind}.log"))
        assert clean and [(r.seq, r.op) for r in recs] == [(1, "delete")]
        np.testing.assert_array_equal(recs[0].arrays["ids"], [1, 2])


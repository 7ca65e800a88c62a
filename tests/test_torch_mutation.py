"""Live mutation in the port (upsert, delete, compact) held against the JAX
reference and against a rebuild over the surviving rows, on the CPU.

Every engine here starts from an index built by ``repro`` (the data and the
build of ``tests/test_mutation.py``) and carried over through ``interop``;
new rows come from numpy seeds. Three holds:

- the list primitives against ``repro.core.lists`` bit for bit, and the
  fixed-shape encoder against ``repro.core.ivf.encode_rows``;
- the port engine against the JAX engine on the same mutation programs:
  stores bit for bit, ``QueryStats`` exactly, dists within f32 tolerance
  and ids tie-aware;
- the port engine against the port's rebuild over the survivors, bit for
  bit (the reference's ``assert_matches_oracle``). The rebuild receives the
  survivors in the order they were written, the order a from-scratch build
  of the same rows gets them; ``test_an_id_order_rebuild_*`` shows why
  that order matters: at the r*k candidate cut, equal quantized distances
  resolve by slot order.
"""
import functools
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ivf as jivf
from repro.core import lists as jlists
from repro.data import vectors as jvec
from repro.engine import EngineConfig as JConfig
from repro.engine import SearchEngine as JEngine
from repro_torch import interop
from repro_torch.core import ivf as tivf
from repro_torch.core import lists as tlists
from repro_torch.core.pq import PQCodebook
from repro_torch.engine import EngineConfig, SearchEngine
from repro_torch.kernels import ops as tops

NLIST, D, M = 16, 32, 8
N0 = 3000
RTOL = 1e-5


@functools.lru_cache(maxsize=None)
def _built():
    ds = jvec.make_sift_like(n=N0, nt=1500, nq=8, d=D, ncl=16, seed=3)
    index = jivf.build_ivf(jax.random.PRNGKey(0), jnp.asarray(ds.train),
                           jnp.asarray(ds.base), m=M, nlist=NLIST,
                           coarse_iters=4, pq_iters=4)
    return ds, index


def _attr_of(gids):
    return (np.asarray(gids, np.int64) % 5).astype(np.int32)


def _arrays(attrs=False) -> dict:
    """The reference index (and base) as interop arrays."""
    ds, index = _built()
    out = dict(jlists.store_arrays(index.lists))
    if attrs:
        out["attrs"] = np.where(out["ids"] >= 0,
                                _attr_of(np.maximum(out["ids"], 0)),
                                -1).astype(np.int32)
    out["centroids"] = np.asarray(index.centroids)
    out["codebook"] = np.asarray(index.codebook.codewords)
    out["base"] = np.array(ds.base)
    return out


def _assert_norms(got, want):
    """Base norms: each package sums x*x in its own order."""
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6)


def port_engine(cfg, *, attrs=False, namespaces=None) -> SearchEngine:
    arrays = _arrays(attrs)
    if namespaces is not None:
        arrays["ns_member"] = np.asarray(namespaces)
    return interop.engine_from_arrays(arrays, config=cfg, device="cpu")


def ref_engine(cfg: EngineConfig, *, attrs=False, namespaces=None):
    arrays = _arrays(attrs)
    _, index = _built()
    store = jlists.store_from_arrays(
        {k: arrays[k] for k in ("codes", "ids", "sizes", "attrs")
         if k in arrays})
    return JEngine(index._replace(lists=store),
                   base=jnp.asarray(arrays["base"]),
                   config=JConfig(**cfg._asdict()),
                   namespaces=None if namespaces is None
                   else jnp.asarray(namespaces))


class Model:
    """Host mirror of the live rows, gid -> vector, in the order they were
    last written (a re-upsert moves its id to the end)."""

    def __init__(self, base: np.ndarray):
        self.rows = {g: np.asarray(base[g]) for g in range(base.shape[0])}

    def delete(self, gids):
        for g in np.asarray(gids).ravel():
            self.rows.pop(int(g), None)

    def upsert(self, gids, vecs):
        for g, v in zip(np.asarray(gids).ravel(), np.asarray(vecs)):
            self.rows.pop(int(g), None)
            self.rows[int(g)] = np.asarray(v, np.float32)

    def survivors(self, order="written"):
        surv = np.array(list(self.rows) if order == "written"
                        else sorted(self.rows), np.int64)
        vecs = (np.stack([self.rows[int(g)] for g in surv]) if surv.size
                else np.zeros((0, D), np.float32))
        return surv, vecs


def rebuild_oracle(model: Model, cap: int, cfg: EngineConfig, *, attrs=False,
                   namespaces=None, order="written"):
    """The port's from-scratch engine over the surviving rows: the same
    centroids, codebook and cap, rows encoded by ``encode_rows`` and
    bucketed by ``build_lists`` in ``order``; its ids are positions into
    ``surv``."""
    arrays = _arrays()
    surv, vecs = model.survivors(order)
    centroids = torch.from_numpy(arrays["centroids"])
    cb = PQCodebook(torch.from_numpy(arrays["codebook"]))
    assign, packed = tivf.encode_rows(centroids, cb, vecs)
    store = tlists.build_lists(assign, packed, nlist=NLIST, cap=cap,
                               ids=np.arange(surv.size, dtype=np.int32),
                               attrs=_attr_of(surv) if attrs else None,
                               device="cpu")
    base = torch.from_numpy(vecs if surv.size else np.zeros((1, D),
                                                            np.float32))
    eng = SearchEngine(tivf.IVFIndex(centroids, cb, store), base=base,
                       config=cfg, namespaces=namespaces)
    return eng, surv


def _to_gids(ids, surv):
    ids = np.asarray(ids)
    return np.where(ids >= 0, surv[np.maximum(ids, 0)] if surv.size else -1,
                    -1)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_matches_oracle(eng, model, q, *, k=10, filter_fn=None,
                          namespaces=None, ns_table=None, order="written"):
    """search and search_jit of the mutated engine against the rebuild, bit
    for bit; the rebuild holds no tombstone."""
    oracle, surv = rebuild_oracle(model, eng.index.lists.cap, eng.config,
                                  attrs=filter_fn is not None,
                                  namespaces=ns_table, order=order)
    fb_live = fb_oracle = None
    if filter_fn is not None:
        fb_live = tlists.filter_from_attrs(eng.index.lists, filter_fn)
        fb_oracle = tlists.filter_from_attrs(oracle.index.lists, filter_fn)
    for call in ("search", "search_jit"):
        got = getattr(eng, call)(q, k, filter_bits=fb_live,
                                 namespaces=namespaces)
        want = getattr(oracle, call)(q, k, filter_bits=fb_oracle,
                                     namespaces=namespaces)
        np.testing.assert_array_equal(got.dists.numpy(), want.dists.numpy(),
                                      err_msg=call)
        np.testing.assert_array_equal(got.ids.numpy(),
                                      _to_gids(want.ids, surv), err_msg=call)
        assert int(want.stats.rows_tombstoned.sum()) == 0
    return oracle, surv


def _mutate(eng, model, *, seed=7, n_delete=200, n_new=150, n_re=50,
            id_base=N0, attrs=False):
    """The reference's canonical program: delete a slab, insert new ids,
    re-upsert existing ones. Returns the upserted (ids, vecs) batches."""
    rng = np.random.default_rng(seed)
    dead = rng.choice(N0, size=n_delete, replace=False)
    assert eng.delete(dead) == n_delete
    model.delete(dead)
    new_ids = np.arange(id_base, id_base + n_new)
    new_vecs = rng.normal(size=(n_new, D)).astype(np.float32)
    kw = {"attrs": _attr_of(new_ids)} if attrs else {}
    eng.upsert(new_ids, new_vecs, **kw)
    model.upsert(new_ids, new_vecs)
    re_ids = np.setdiff1d(np.arange(N0), dead)[:n_re]
    re_vecs = rng.normal(size=(n_re, D)).astype(np.float32)
    kw = {"attrs": _attr_of(re_ids)} if attrs else {}
    eng.upsert(re_ids, re_vecs, **kw)
    model.upsert(re_ids, re_vecs)
    return [(new_ids, new_vecs), (re_ids, re_vecs)]


def _queries():
    return np.asarray(_built()[0].queries)


def _ns_table():
    member = np.zeros((2, NLIST), bool)
    member[0, :NLIST // 2] = True
    member[1, NLIST // 2:] = True
    return member


NS = np.asarray([0, 1, -1, 0, 1, -1, 0, 1], np.int32)


# ---------------------------------------------------------------------------
# list primitives, bit for bit against repro.core.lists
# ---------------------------------------------------------------------------

def _tiny_arrays(attrs=False):
    rng = np.random.default_rng(0)
    assign = np.repeat(np.arange(4), (3, 0, 5, 2))
    packed = rng.integers(0, 256, (assign.size, 2), np.uint8)
    out = jlists.store_arrays(jlists.build_lists(assign, packed, nlist=4,
                                                 cap=8))
    if attrs:
        out["attrs"] = np.where(out["ids"] >= 0,
                                _attr_of(np.maximum(out["ids"], 0)),
                                -1).astype(np.int32)
    return out


def _case_append(L, st, st_a):
    st2, slots = L.append_rows(st, np.array([0, 2, 0]),
                               np.full((3, 2), 9, np.uint8),
                               np.array([100, 101, 102], np.int32))
    yield st2
    yield slots
    # a list out of spare capacity refuses the whole batch
    yield lambda: L.append_rows(st2, np.full(4, 2),
                                np.zeros((4, 2), np.uint8),
                                np.arange(200, 204, dtype=np.int32))


def _case_append_attrs(L, st, st_a):
    yield lambda: L.append_rows(st, np.array([0]), np.zeros((1, 2), np.uint8),
                                np.array([7], np.int32),
                                attrs=np.array([1], np.int32))
    st2, slots = L.append_rows(st_a, np.array([1, 3]),
                               np.zeros((2, 2), np.uint8),
                               np.array([7, 8], np.int32),
                               attrs=np.array([42, 43], np.int32))
    yield st2
    yield slots
    st3, _ = L.append_rows(st2, np.array([1]), np.ones((1, 2), np.uint8),
                           np.array([9], np.int32))     # attrs default -1
    yield st3


def _case_tombstone(L, st, st_a):
    st2 = L.tombstone_rows(st_a, np.array([0, 2]), np.array([1, 4]))
    yield st2
    yield L.live_counts(st2)
    yield L.tombstone_counts(st2)
    yield L.live_filter_bits(st2)


def _case_compact(L, st, st_a):
    st2 = L.tombstone_rows(st_a, np.array([2, 2, 0]), np.array([0, 3, 1]))
    yield L.compact_lists(st2)
    yield lambda: L.compact_lists(st2, cap=2)       # below the largest list
    yield L.compact_lists(st2, cap=4)
    yield L.compact_lists(st2, cap=12)


def _case_locate(L, st, st_a):
    st2 = L.tombstone_rows(st, np.array([0]), np.array([0]))
    yield L.locate_rows(st2)
    yield L.locate_rows(L.tombstone_rows(st2, np.array([2, 3]),
                                         np.array([4, 1])))


def _case_grow(L, st, st_a):
    yield L.grow_cap(st_a, 16)
    yield lambda: L.grow_cap(st_a, 4)


LIST_CASES = {"append": _case_append, "append_attrs": _case_append_attrs,
              "tombstone": _case_tombstone, "compact": _case_compact,
              "locate": _case_locate, "grow_cap": _case_grow}


def _outcome(x):
    """A comparable host form of one step's result."""
    if callable(x):
        try:
            x = x()
        except ValueError as e:
            return ("raises", str(e))
    if isinstance(x, tuple) and hasattr(x, "_fields"):       # a ListStore
        return {k: np.array(_np(v)) for k, v in x._asdict().items()
                if v is not None}
    if isinstance(x, dict):
        return x
    return np.array(_np(x))     # a copy: a later in-place step may write


def _run_case(name, L, from_arrays, *, chain="in_place"):
    """The case's outcomes. The port's mutators write in place: under
    ``chain='cloned'`` each call gets a clone of its store, so every step
    reads the store it was handed, as the reference's functional calls do;
    under ``'in_place'`` the steps chain over the same tensors, as the
    engine drives them."""
    fns = L
    if chain == "cloned":
        class _Cloned:
            def __getattr__(self, attr):
                fn = getattr(L, attr)
                if attr not in ("append_rows", "tombstone_rows",
                                "compact_lists"):
                    return fn

                def call(store, *args, **kwargs):
                    return fn(store._replace(**{
                        k: v.clone() for k, v in store._asdict().items()
                        if v is not None}), *args, **kwargs)
                return call
        fns = _Cloned()
    st = from_arrays(_tiny_arrays())
    st_a = from_arrays(_tiny_arrays(attrs=True))
    return [_outcome(x) for x in LIST_CASES[name](fns, st, st_a)]


def _assert_same(got, want, what):
    assert type(got) is type(want) or isinstance(got, np.ndarray), what
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), what
        for k in want:
            _assert_same(got[k], want[k], (what, k))
    elif isinstance(want, tuple):
        assert got == want, what
    else:
        assert got.dtype == np.asarray(want).dtype, what
        np.testing.assert_array_equal(got, want, err_msg=str(what))


@pytest.mark.parametrize("chain", ["cloned", "in_place"])
@pytest.mark.parametrize("name", sorted(LIST_CASES))
def test_list_primitives_equal_the_reference(name, chain):
    want = _run_case(name, jlists, jlists.store_from_arrays)
    got = _run_case(name, tlists,
                    functools.partial(tlists.store_from_arrays, device="cpu"),
                    chain=chain)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        _assert_same(g, w, (name, i))


def test_list_primitives_write_in_place():
    """tombstone_rows, append_rows and compact_lists at the same cap write
    into the store's own tensors and return them; compaction to another cap
    returns new tensors and leaves the store as it was."""
    st = tlists.store_from_arrays(_tiny_arrays(attrs=True), device="cpu")
    ids, codes, sizes, attrs = st.ids, st.codes, st.sizes, st.attrs
    same = tlists.tombstone_rows(st, np.array([0]), np.array([0]))
    assert same.ids is ids and same.attrs is attrs
    assert int(ids[0, 0]) == int(attrs[0, 0]) == -1
    same, slots = tlists.append_rows(st, np.array([1]),
                                     np.full((1, 2), 7, np.uint8),
                                     np.array([70], np.int32))
    assert same.codes is codes and same.sizes is sizes and int(slots[0]) == 0
    assert int(ids[1, 0]) == 70 and int(sizes[1]) == 1
    before = {k: v.clone() for k, v in st._asdict().items()}
    grown = tlists.compact_lists(st, cap=16)
    assert grown.ids is not ids and grown.cap == 16
    for k, v in before.items():
        assert torch.equal(getattr(st, k), v), k
    same = tlists.compact_lists(st)
    assert same.ids is ids and same.codes is codes and same.sizes is sizes
    assert int(ids[0, 0]) == 1 and int(sizes[0]) == 2   # shifted down
    wide = tlists.store_arrays(grown)
    for k, v in tlists.store_arrays(same).items():
        np.testing.assert_array_equal(
            v, wide[k] if k == "sizes" else wide[k][:, :8], err_msg=k)


# ---------------------------------------------------------------------------
# the fixed-shape encoder
# ---------------------------------------------------------------------------

def _port_coder():
    arrays = _arrays()
    return (torch.from_numpy(arrays["centroids"]),
            PQCodebook(torch.from_numpy(arrays["codebook"])))


def test_encode_rows_is_batch_independent_bit_for_bit():
    cen, cb = _port_coder()
    rng = np.random.default_rng(5)
    rows = np.concatenate([np.array(_built()[0].base[:700]),
                           rng.normal(size=(300, D)).astype(np.float32)])
    a_all, p_all = tivf.encode_rows(cen, cb, rows)
    for pos in (0, 17, 255, 256, 511):     # in a chunk and past its edge
        for size in (pos + 1, pos + 2, 600):
            batch = rng.normal(size=(size, D)).astype(np.float32)
            other = pos + 1 if pos + 1 < size else pos - 1
            batch[pos] = rows[3]
            if other >= 0:
                batch[other] = rows[950]
            a, p = tivf.encode_rows(cen, cb, batch)
            for j, i in ((pos, 3), (other, 950)):
                if j >= 0:
                    assert a[j] == a_all[i], (pos, size)
                    assert (p[j] == p_all[i]).all(), (pos, size)
    for lo, hi in ((0, 1), (5, 261), (255, 257), (100, 1000)):
        a, p = tivf.encode_rows(cen, cb, rows[lo:hi])
        np.testing.assert_array_equal(a, a_all[lo:hi])
        np.testing.assert_array_equal(p, p_all[lo:hi])
    assert a_all.dtype == np.int32 and p_all.dtype == np.uint8


def _near_tie(d: np.ndarray, rel=1e-5) -> np.ndarray:
    """(n, k) distances -> (n,) whether the two smallest are within rel."""
    two = np.sort(d, axis=-1)[..., :2]
    return two[..., 1] - two[..., 0] <= rel * np.maximum(np.abs(two[..., 1]),
                                                         1e-30)


def test_encode_rows_matches_the_reference_but_near_ties():
    ds, index = _built()
    cen, cb = _port_coder()
    rng = np.random.default_rng(6)
    rows = np.concatenate([np.array(ds.base), np.array(ds.train),
                           rng.normal(size=(500, D)).astype(np.float32)])
    ja, jp = jivf.encode_rows(index.centroids, index.codebook,
                              jnp.asarray(rows))
    ta, tp = tivf.encode_rows(cen, cb, rows)
    ja, jp = np.asarray(ja), np.asarray(jp)
    c = np.asarray(index.centroids, np.float64)
    dc = ((rows[:, None, :].astype(np.float64) - c[None]) ** 2).sum(-1)
    bad_a = ja != ta
    assert _near_tie(dc[bad_a]).all()
    same = ~bad_a
    bad_p = same & (jp != tp).any(1)
    if bad_p.any():
        resid = rows[bad_p] - c[ja[bad_p]]
        cw = np.asarray(index.codebook.codewords, np.float64)
        sub = resid.reshape(resid.shape[0], M, 1, D // M)
        ds_ = ((sub - cw[None]) ** 2).sum(-1)         # (n, M, 16)
        assert _near_tie(ds_).any(axis=1).all()
    n_bad = int(bad_a.sum() + bad_p.sum())
    print(f"encode_rows: {n_bad} of {rows.shape[0]} rows differ from the "
          "reference, each at a near tie")
    assert n_bad <= 0.01 * rows.shape[0]


def test_port_build_encodes_through_encode_rows():
    ds, _ = _built()
    train, base = np.array(ds.train), np.array(ds.base)
    eng = SearchEngine.build(train, base, m=M, nlist=NLIST, coarse_iters=4,
                             pq_iters=4, seed=1, device="cpu")
    idx = eng.index
    a, p = tivf.encode_rows(idx.centroids, idx.codebook, base)
    ids = idx.lists.ids.numpy()
    ls, ss = np.nonzero(ids >= 0)
    g = ids[ls, ss]
    np.testing.assert_array_equal(ls, a[g])
    np.testing.assert_array_equal(idx.lists.codes.numpy()[ls, ss], p[g])


# ---------------------------------------------------------------------------
# the port engine against the JAX engine on the same mutation programs
# ---------------------------------------------------------------------------

def _prog_canonical(eng, model, **kw):
    return _mutate(eng, model)


def _prog_filtered(eng, model, **kw):
    return _mutate(eng, model, seed=11, n_delete=150, n_new=100, n_re=40,
                   attrs=True)


def _prog_namespaced(eng, model, **kw):
    return _mutate(eng, model, seed=13)


def _prog_post_compact(eng, model, **kw):
    out = _mutate(eng, model)
    eng.delete(np.arange(3100, 3120))
    model.delete(np.arange(3100, 3120))
    assert eng.compact() == 20
    live = (_np(eng.index.lists.ids) >= 0).sum(1)
    tight = -(-int(live.max()) // 8) * 8
    eng.compact(cap=tight)
    return out


def _prog_growth(eng, model, **kw):
    cap0 = eng.index.lists.cap
    sizes = _np(eng.index.lists.sizes)
    target = int(np.argmax(sizes))
    cvec = _np(eng.index.centroids)[target]
    new_ids = np.arange(4000, 4000 + cap0)
    new_vecs = (cvec[None, :] + 0.01 * np.random.default_rng(5).normal(
        size=(cap0, D))).astype(np.float32)
    eng.upsert(new_ids, new_vecs)
    model.upsert(new_ids, new_vecs)
    assert eng.index.lists.cap > cap0 and eng.index.lists.cap % 8 == 0
    return [(new_ids, new_vecs)]


# (program, scan_impl, rerank_impl, attrs, namespaced)
PROGRAMS = {
    "canonical-ref-gathered": (_prog_canonical, "ref", "gathered"),
    "canonical-ref-stream": (_prog_canonical, "ref", "stream"),
    "canonical-stream-gathered": (_prog_canonical, "stream", "gathered"),
    "canonical-stream-stream": (_prog_canonical, "stream", "stream"),
    "filtered-stream": (_prog_filtered, "stream", "gathered"),
    "namespaced-stream": (_prog_namespaced, "stream", "gathered"),
    "post_compact-stream": (_prog_post_compact, "stream", "stream"),
    "growth-ref": (_prog_growth, "ref", "gathered"),
}


def _norm_atol(q: np.ndarray, base) -> np.ndarray:
    """(Q, 1) absolute f32 tolerance of an exact distance computed as
    ``(‖q‖² - 2·q·x) + ‖x‖²`` in another summation order: four ulps of the
    largest term, ``2**-21 (‖q‖² + max ‖x‖²)``. It exceeds RTOL of the
    distance only for rows far smaller than the query (near the origin)."""
    big = float((_np(base).astype(np.float64) ** 2).sum(1).max())
    return 2.0 ** -21 * ((q.astype(np.float64) ** 2).sum(1) + big)[:, None]


def _assert_tie_aware(got_v, got_i, want_v, want_i, atol=0.0, rtol=RTOL):
    """Values within rtol plus ``atol`` (scalar or (Q, 1)); ids equal up to
    order inside runs of values within that tolerance of each other."""
    got_v, want_v = _np(got_v), _np(want_v)
    got_i, want_i = _np(got_i), _np(want_i)
    atol = np.broadcast_to(np.asarray(atol, np.float64),
                           (want_v.shape[0], 1))
    np.testing.assert_array_less(
        np.abs(got_v.astype(np.float64) - want_v),
        rtol * np.abs(want_v) + atol + 1e-30)
    for q in range(want_v.shape[0]):
        i, k = 0, want_v.shape[1]
        while i < k:
            j = i + 1
            while j < k and (abs(want_v[q, j] - want_v[q, j - 1])
                             <= rtol * abs(want_v[q, j]) + atol[q, 0]):
                j += 1
            assert sorted(got_i[q, i:j]) == sorted(want_i[q, i:j]), (q, i, j)
            i = j


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_mutated_engine_matches_the_jax_engine(name):
    prog, scan, rerank = PROGRAMS[name]
    attrs = name.startswith("filtered")
    member = _ns_table() if name.startswith("namespaced") else None
    cfg = EngineConfig(nprobe=8, rerank_mult=4, scan_impl=scan,
                       rerank_impl=rerank)
    jeng = ref_engine(cfg, attrs=attrs, namespaces=member)
    teng = port_engine(cfg, attrs=attrs, namespaces=member)
    batches = prog(teng, Model(np.array(_built()[0].base)))
    _, index = _built()
    cen, cb = _port_coder()
    for ids, vecs in batches:      # the two encoders agree on every row
        ja, jp = jivf.encode_rows(index.centroids, index.codebook,
                                  jnp.asarray(vecs))
        ta, tp = tivf.encode_rows(cen, cb, vecs)
        np.testing.assert_array_equal(ta, np.asarray(ja))
        np.testing.assert_array_equal(tp, np.asarray(jp))
    prog(jeng, Model(np.array(_built()[0].base)))
    want = jlists.store_arrays(jeng.index.lists)
    got = tlists.store_arrays(teng.index.lists)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(teng.base.numpy(), np.asarray(jeng.base))
    _assert_norms(teng.base_norms, jeng.base_norms)
    assert (teng.epoch, teng.n_tombstones) == (jeng.epoch, jeng.n_tombstones)
    assert (teng.live_bits is None) == (jeng.live_bits is None)
    if teng.live_bits is not None:
        np.testing.assert_array_equal(teng.live_bits.numpy(),
                                      np.asarray(jeng.live_bits))
    q = _queries()
    kw = {}
    if attrs:
        kw["filter_bits"] = (lambda a: (a % 5) != 2)
    for call in ("search", "search_jit"):
        kt, kj = {}, {}
        if attrs:
            kt["filter_bits"] = tlists.filter_from_attrs(teng.index.lists,
                                                         kw["filter_bits"])
            kj["filter_bits"] = jlists.filter_from_attrs(jeng.index.lists,
                                                         kw["filter_bits"])
        if member is not None:
            kt["namespaces"] = NS
            kj["namespaces"] = jnp.asarray(NS)
        got = getattr(teng, call)(q, 10, **kt)
        want = getattr(jeng, call)(jnp.asarray(q), 10, **kj)
        _assert_tie_aware(got.dists, got.ids, want.dists, want.ids,
                          atol=_norm_atol(q, teng.base))
        for field in want.stats._fields:
            np.testing.assert_array_equal(
                getattr(got.stats, field).numpy(),
                np.asarray(getattr(want.stats, field)), err_msg=(call, field))


# ---------------------------------------------------------------------------
# the port engine against the port's rebuild over the survivors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scan_impl", ["ref", "stream"])
@pytest.mark.parametrize("rerank_impl", ["gathered", "stream"])
def test_mutation_oracle_bit_identity(scan_impl, rerank_impl):
    cfg = EngineConfig(nprobe=8, rerank_mult=4, scan_impl=scan_impl,
                       rerank_impl=rerank_impl)
    eng = port_engine(cfg)
    model = Model(np.array(_built()[0].base))
    _mutate(eng, model)
    assert_matches_oracle(eng, model, _queries())


def test_mutation_oracle_no_rerank():
    eng = port_engine(EngineConfig(nprobe=8, rerank_mult=0))
    model = Model(np.array(_built()[0].base))
    _mutate(eng, model)
    assert_matches_oracle(eng, model, _queries())


@pytest.mark.parametrize("scan_impl", ["ref", "stream"])
def test_mutation_oracle_filtered(scan_impl):
    eng = port_engine(EngineConfig(nprobe=8, rerank_mult=4,
                                   scan_impl=scan_impl), attrs=True)
    model = Model(np.array(_built()[0].base))
    rng = np.random.default_rng(11)
    dead = rng.choice(N0, size=150, replace=False)
    eng.delete(dead)
    model.delete(dead)
    new_ids = np.arange(N0, N0 + 100)
    new_vecs = rng.normal(size=(100, D)).astype(np.float32)
    eng.upsert(new_ids, new_vecs, attrs=_attr_of(new_ids))
    model.upsert(new_ids, new_vecs)
    assert_matches_oracle(eng, model, _queries(),
                          filter_fn=lambda a: (a % 5) != 2)


@pytest.mark.parametrize("scan_impl", ["ref", "stream"])
def test_mutation_oracle_namespaced(scan_impl):
    member = _ns_table()
    eng = port_engine(EngineConfig(nprobe=8, rerank_mult=4,
                                   scan_impl=scan_impl), namespaces=member)
    model = Model(np.array(_built()[0].base))
    _mutate(eng, model, seed=13)
    assert_matches_oracle(eng, model, _queries(), namespaces=NS,
                          ns_table=member)
    # isolation survives mutation: a restricted query sees its lists only
    r = eng.search(_queries(), 10, namespaces=NS)
    for qi, t in enumerate(NS):
        for g in r.ids[qi].tolist():
            if t >= 0 and g >= 0:
                assert member[t, eng.locate(g)[0]]


def test_post_compact_bit_identity_and_shrink():
    cfg = EngineConfig(nprobe=8, rerank_mult=4, scan_impl="stream",
                       rerank_impl="stream")
    eng = port_engine(cfg)
    model = Model(np.array(_built()[0].base))
    _mutate(eng, model)
    dead = np.arange(100, 160)
    eng.delete(dead)
    model.delete(dead)
    n_tomb = eng.n_tombstones
    assert n_tomb > 0
    assert eng.compact() == n_tomb
    assert eng.n_tombstones == 0 and eng.live_bits is None
    assert_matches_oracle(eng, model, _queries())
    live = tlists.live_counts(eng.index.lists)
    tight = -(-int(live.max()) // 8) * 8
    assert tight < eng.index.lists.cap
    eng.compact(cap=tight)
    assert eng.index.lists.cap == tight
    assert_matches_oracle(eng, model, _queries())


def test_capacity_growth_keeps_oracle_parity():
    eng = port_engine(EngineConfig(nprobe=8, rerank_mult=4))
    model = Model(np.array(_built()[0].base))
    _prog_growth(eng, model)
    assert_matches_oracle(eng, model, _queries())


def test_upsert_replaces_vector_exactly():
    eng = port_engine(EngineConfig(nprobe=NLIST, rerank_mult=8))
    probe = np.full((D,), 7.5, np.float32)        # far from everything
    eng.upsert(np.array([42]), probe[None, :])
    r = eng.search(probe, 1)
    assert int(r.ids[0, 0]) == 42 and float(r.dists[0, 0]) == 0.0


def test_delete_everything_returns_sentinels():
    eng = port_engine(EngineConfig(nprobe=8, rerank_mult=4))
    assert eng.delete(np.arange(N0)) == N0
    r = eng.search(_queries(), 10)
    assert (r.ids == -1).all() and torch.isinf(r.dists).all()
    row = np.array(_built()[0].base[7])
    eng.upsert(np.array([7]), row[None, :])
    assert int(eng.search(row, 1).ids[0, 0]) == 7


@pytest.mark.parametrize("write", ["delete", "upsert", "compact"])
def test_engines_over_one_index_stay_independent(write):
    """Two engines built over the same tensors: the first write of one
    clones what it mutates, so the other's results, store, base and norms
    stay those of the index it was given, and the writer's equal an engine
    that owned copies from the start."""
    cfg = EngineConfig(nprobe=8, rerank_mult=4, scan_impl="stream",
                       rerank_impl="stream")
    a = port_engine(cfg)
    b = SearchEngine(a.index, base=a.base, base_norms=a.base_norms,
                     config=cfg)
    solo = port_engine(cfg)
    q = _queries()
    before = b.search(q, 10)
    kept = {k: v.clone() for k, v in a.index.lists._asdict().items()
            if v is not None}
    kept.update(base=a.base.clone(), base_norms=a.base_norms.clone())
    rng = np.random.default_rng(4)
    for e in (a, solo):
        if write == "delete":
            assert e.delete(np.arange(0, N0, 3)) == N0 // 3
        elif write == "upsert":
            e.upsert(np.arange(0, 300, 2),
                     rng.normal(size=(150, D)).astype(np.float32))
        else:
            e.delete(np.arange(0, N0, 5))
            e.compact(cap=2 * b.index.lists.cap)
    for k, v in kept.items():
        got = getattr(b, k) if k.startswith("base") else getattr(
            b.index.lists, k)
        assert torch.equal(got, v), k
    assert b.live_bits is None and b.n_tombstones == 0 and b.epoch == 0
    after = b.search(q, 10)
    for x, y in zip(_flat(after), _flat(before)):
        assert torch.equal(x, y)
    for x, y in zip(_flat(a.search(q, 10)), _flat(solo.search(q, 10))):
        assert torch.equal(x, y)


def _flat(result):
    return (result.dists, result.ids, *result.stats)


def test_epoch_counters_and_noop_mutations():
    eng = port_engine(EngineConfig(nprobe=8, rerank_mult=4))
    assert eng.epoch == 0 and eng.n_tombstones == 0 and eng.live_bits is None
    assert eng.delete([99999]) == 0 and eng.epoch == 0
    assert eng.upsert(np.empty(0, np.int64), np.empty((0, D))).size == 0
    assert eng.epoch == 0
    assert eng.delete([5, 5, 6]) == 2
    assert eng.epoch == 1 and eng.n_tombstones == 2
    assert eng.live_bits is not None
    assert eng.locate(5) is None and eng.locate(7) is not None
    eng.upsert(np.array([5]), np.array(_built()[0].base[5])[None, :])
    assert eng.epoch == 2 and eng.locate(5) is not None
    # a WAL attaches and detaches; a no-op delete logs nothing
    records = []

    class Log:
        def log_delete(self, ids):
            records.append(("delete", list(ids)))

    eng.attach_wal(Log())
    assert eng.delete([99999]) == 0 and eng.delete([8]) == 1
    eng.attach_wal(None)
    eng.delete([9])
    assert records == [("delete", [8])] and eng.epoch == 4


def test_upsert_validation_leaves_the_engine_as_it_was():
    eng = port_engine(EngineConfig(nprobe=8, rerank_mult=4))
    before = interop.arrays_from_engine(eng)
    with pytest.raises(ValueError):
        eng.upsert(np.array([1, 2]), np.zeros((3, D)))
    with pytest.raises(ValueError):
        eng.upsert(np.array([-1]), np.zeros((1, D)))
    with pytest.raises(ValueError):
        eng.upsert(np.array([1, 1]), np.zeros((2, D)))
    with pytest.raises(ValueError, match="D="):
        eng.upsert(np.array([1]), np.zeros((1, D + 1)))
    with pytest.raises(ValueError, match="attrs"):
        eng.upsert(np.array([1]), np.zeros((1, D)),
                   attrs=np.array([3], np.int32))
    after = interop.arrays_from_engine(eng)
    for k in before:
        np.testing.assert_array_equal(after[k], before[k], err_msg=k)
    assert eng.epoch == 0


def test_stats_partition_filtered_vs_tombstoned():
    eng = port_engine(EngineConfig(nprobe=NLIST, rerank_mult=4), attrs=True)
    q = _queries()
    eng.delete(np.arange(0, 600))
    fb_all = tlists.filter_from_attrs(eng.index.lists, lambda a: a >= 0)
    r = eng.search(q, 10, filter_bits=fb_all)
    assert (r.stats.rows_filtered == 0).all()
    assert (r.stats.rows_tombstoned == 600).all()
    fb = tlists.filter_from_attrs(eng.index.lists, lambda a: (a % 5) == 0)
    r2 = eng.search(q, 10, filter_bits=fb)
    gids = np.arange(N0)
    passing = int(((_attr_of(gids) % 5 == 0) & (gids >= 600)).sum())
    assert (r2.stats.rows_filtered == N0 - 600 - passing).all()
    assert (r2.stats.rows_tombstoned == 600).all()
    r3 = eng.search(q, 10)
    assert (r3.stats.rows_filtered == 0).all()
    assert (r3.stats.rows_tombstoned == 600).all()


def test_stale_filter_width_rejected_after_growth():
    eng = port_engine(EngineConfig(nprobe=8, rerank_mult=4), attrs=True)
    fb = tlists.filter_from_attrs(eng.index.lists, lambda a: a >= 0)
    cap0 = eng.index.lists.cap
    target = int(np.argmax(eng.index.lists.sizes.numpy()))
    cvec = eng.index.centroids[target].numpy()
    vecs = (cvec[None, :] + 0.01 * np.random.default_rng(6).normal(
        size=(cap0, D))).astype(np.float32)
    new_ids = np.arange(5000, 5000 + cap0)
    eng.upsert(new_ids, vecs, attrs=_attr_of(new_ids))
    assert eng.index.lists.cap > cap0
    assert fb.shape[1] < tlists.filter_words(eng.index.lists.cap)
    with pytest.raises(ValueError, match="cap"):
        eng.search(_queries(), 10, filter_bits=fb)


def test_cap_changes_retire_scan_verdicts_and_base_growth_rerank_ones():
    saved = tops.autotune_cache()
    try:
        tops.clear_autotune_cache()
        eng = port_engine(EngineConfig(nprobe=8, rerank_mult=4,
                                       scan_impl="auto", rerank_impl="auto"))
        q = _queries()
        cap0 = eng.index.lists.cap
        eng.search(q, 10)
        scan = [k for k in tops.autotune_cache()
                if k[0] == "scan" and k[4] == cap0 and k[6] == NLIST]
        rerank = [k for k in tops.autotune_cache()
                  if k[0] == "rerank" and k[7] == N0]
        assert scan and rerank
        eng.delete(np.arange(500))
        tight = -(-int(tlists.live_counts(eng.index.lists).max()) // 8) * 8
        assert tight < cap0
        eng.compact(cap=tight)
        snap = tops.autotune_cache()
        assert not any(k in snap for k in scan)
        assert all(k in snap for k in rerank)
        n0 = tops.autotune_cache_size()
        eng.search(q, 10)                   # sweeps the new cap once
        assert tops.autotune_cache_size() == n0 + 1
        eng.upsert(np.array([N0 + 300]), np.zeros((1, D), np.float32))
        assert eng.base.shape[0] == -(-(N0 + 301) // 256) * 256
        assert not any(k in tops.autotune_cache() for k in rerank)
    finally:
        tops.clear_autotune_cache()
        tops._AUTOTUNE_CACHE.update(saved)


def test_base_grows_in_256_row_blocks_with_rowwise_norms():
    eng = port_engine(EngineConfig(nprobe=8, rerank_mult=4))
    rng = np.random.default_rng(3)
    vecs = rng.normal(size=(3, D)).astype(np.float32)
    eng.upsert(np.array([N0 + 5, 17, N0 + 600]), vecs)
    assert eng.base.shape == (-(-(N0 + 601) // 256) * 256, D)
    np.testing.assert_array_equal(eng.base[[N0 + 5, 17, N0 + 600]].numpy(),
                                  vecs)
    np.testing.assert_array_equal(
        eng.base_norms.numpy(), tlists.base_norms(eng.base).numpy())
    assert float(eng.base[N0 + 1].abs().sum()) == 0.0


# ---------------------------------------------------------------------------
# why the rebuild takes the survivors in write order
# ---------------------------------------------------------------------------

def _pool_cut(eng, q, ns, surv=None):
    """Each query's r*k candidate cut on the quantized pool: (the value at
    the cut, the ids that hold exactly that value, the ids kept below it,
    the ids kept at it), ids as gids."""
    from repro_torch.engine import engine as E
    st = eng._state
    qq = torch.from_numpy(q)
    probes, _ = E.coarse_probes(eng.coarse, qq, nprobe=8,
                                ns_member=eng.ns_member,
                                namespaces=torch.from_numpy(ns))
    fd, fi, _ = E.scan_candidates(st.index, qq, probes, scan_impl="ref",
                                  filter_bits=st.live_bits)
    fd, fi = fd.numpy(), fi.numpy()
    if surv is not None:
        fi = _to_gids(fi, surv)
    out = []
    for d, i in zip(fd, fi):
        order = np.lexsort((np.arange(d.size), d))
        order = order[i[order] >= 0][:40]
        cut = d[order[-1]]
        out.append((cut, set(i[(d == cut) & (i >= 0)].tolist()),
                    set(i[order][d[order] < cut].tolist()),
                    set(i[order][d[order] == cut].tolist())))
    return out


def test_an_id_order_rebuild_breaks_ties_at_the_candidate_cut_differently():
    """The reference's namespaced program, held to a rebuild that lays the
    survivors out in id order: the re-upserted rows (ids 0-52, near the
    origin) and the new ones (3000+) encode alike, so dozens of rows share
    one quantized distance at a query's r*k cut. The cut keeps the tied
    rows of lowest slot, and the two layouts put different rows first: the
    mutated engine's the new ids, the id-order rebuild's the re-upserted
    ones. Everything below the cut, and the cut itself, agree; the final
    results differ only where the kept tied rows do. In write order the two
    layouts agree and so do the results (the oracle tests above)."""
    member = _ns_table()
    cfg = EngineConfig(nprobe=8, rerank_mult=4, scan_impl="ref")
    eng = port_engine(cfg, namespaces=member)
    model = Model(np.array(_built()[0].base))
    _mutate(eng, model, seed=13)
    q = _queries()
    oracle, surv = rebuild_oracle(model, eng.index.lists.cap, cfg,
                                  namespaces=member, order="id")
    got = eng.search(q, 10, namespaces=NS)
    want = oracle.search(q, 10, namespaces=NS)
    differ = np.nonzero((got.dists != want.dists).any(1).numpy()
                        | (got.ids.numpy() != _to_gids(want.ids, surv))
                        .any(1))[0]
    assert differ.size           # the id-order rebuild is not matched
    mine = _pool_cut(eng, q, NS)
    theirs = _pool_cut(oracle, q, NS, surv)
    for qi in range(q.shape[0]):
        cut, tied, below, kept = mine[qi]
        cut_o, tied_o, below_o, kept_o = theirs[qi]
        assert cut == cut_o and tied == tied_o and below == below_o
        if qi in differ:
            # a tie group straddles the cut, and each layout keeps other
            # members of it
            assert len(tied) > len(kept) and kept != kept_o
            assert max(kept) >= N0 and max(kept_o) < N0
    assert_matches_oracle(eng, model, q, namespaces=NS, ns_table=member)


def _ref_write_order_oracle(jeng, model, q, ns=None, member=None):
    """The reference engine against a reference rebuild of the survivors in
    write order: (dists equal, ids equal) for search and search_jit."""
    _, index = _built()
    surv, vecs = model.survivors("written")
    a, p = jivf.encode_rows(index.centroids, index.codebook,
                            jnp.asarray(vecs))
    store = jlists.build_lists(np.asarray(a), np.asarray(p), nlist=NLIST,
                               cap=jeng.index.lists.cap,
                               ids=np.arange(surv.size, dtype=np.int32))
    orc = JEngine(index._replace(lists=store), base=jnp.asarray(vecs),
                  config=jeng.config,
                  namespaces=None if member is None else jnp.asarray(member))
    kw = {} if ns is None else {"namespaces": jnp.asarray(ns)}
    for call in ("search", "search_jit"):
        got = getattr(jeng, call)(jnp.asarray(q), 10, **kw)
        want = getattr(orc, call)(jnp.asarray(q), 10, **kw)
        np.testing.assert_array_equal(np.asarray(got.dists),
                                      np.asarray(want.dists), err_msg=call)
        np.testing.assert_array_equal(np.asarray(got.ids),
                                      _to_gids(want.ids, surv), err_msg=call)


@pytest.mark.parametrize("program", ["namespaced", "post_compact"])
def test_reference_matches_a_write_order_rebuild(program):
    """The two single-host cases the reference's own id-order oracle fails
    (``tests/test_mutation.py``): against a rebuild in write order the JAX
    engine matches bit for bit, as the port does."""
    q = _queries()
    if program == "namespaced":
        member = _ns_table()
        jeng = ref_engine(EngineConfig(nprobe=8, rerank_mult=4,
                                       scan_impl="stream"),
                          namespaces=member)
        model = Model(np.array(_built()[0].base))
        _mutate(jeng, model, seed=13)
        _ref_write_order_oracle(jeng, model, q, NS, member)
    else:
        jeng = ref_engine(EngineConfig(nprobe=8, rerank_mult=4,
                                       scan_impl="stream",
                                       rerank_impl="stream"))
        model = Model(np.array(_built()[0].base))
        _mutate(jeng, model)
        jeng.compact()
        _ref_write_order_oracle(jeng, model, q)
        live = np.asarray(jlists.live_counts(jeng.index.lists))
        jeng.compact(cap=-(-int(live.max()) // 8) * 8)
        _ref_write_order_oracle(jeng, model, q)


# ---------------------------------------------------------------------------
# interop: tombstoned engines cross both ways
# ---------------------------------------------------------------------------

def _assert_engines_agree(teng, jeng, q):
    for call in ("search", "search_jit"):
        got = getattr(teng, call)(q, 10)
        want = getattr(jeng, call)(jnp.asarray(q), 10)
        _assert_tie_aware(got.dists, got.ids, want.dists, want.ids,
                          atol=_norm_atol(q, teng.base))
        for field in want.stats._fields:
            np.testing.assert_array_equal(
                getattr(got.stats, field).numpy(),
                np.asarray(getattr(want.stats, field)), err_msg=field)


def test_a_tombstoned_reference_engine_opens_in_the_port():
    cfg = EngineConfig(nprobe=8, rerank_mult=4, scan_impl="stream")
    jeng = ref_engine(cfg)
    jeng.upsert(np.array([10, 3001]),
                np.random.default_rng(2).normal(size=(2, D)).astype(
                    np.float32))
    jeng.delete(np.arange(0, 3000, 7))
    arrays = dict(jlists.store_arrays(jeng.index.lists))
    arrays.update(centroids=np.asarray(jeng.index.centroids),
                  codebook=np.asarray(jeng.index.codebook.codewords),
                  base=np.asarray(jeng.base),
                  base_norms=np.asarray(jeng.base_norms),
                  live_bits=np.asarray(jeng.live_bits))
    teng = interop.engine_from_arrays(arrays, config=cfg, device="cpu")
    assert teng.n_tombstones == jeng.n_tombstones > 0
    np.testing.assert_array_equal(teng.live_bits.numpy(), arrays["live_bits"])
    back = interop.arrays_from_engine(teng)
    assert sorted(back) == sorted(arrays)
    for k in arrays:
        np.testing.assert_array_equal(back[k], arrays[k], err_msg=k)
    _assert_engines_agree(teng, jeng, _queries())
    # and it keeps mutating as the reference does
    for e in (teng, jeng):
        assert e.delete(np.arange(1, 3000, 7)) == 429
        e.compact()
    _assert_engines_agree(teng, jeng, _queries())


def test_a_mutated_port_engine_opens_in_the_reference():
    cfg = EngineConfig(nprobe=8, rerank_mult=4, scan_impl="stream",
                       rerank_impl="stream")
    teng = port_engine(cfg)
    _mutate(teng, Model(np.array(_built()[0].base)))
    teng.delete(np.arange(2000, 2100))
    arrays = interop.arrays_from_engine(teng)
    assert "live_bits" in arrays
    _, index = _built()
    store = jlists.store_from_arrays(arrays)
    jeng = JEngine(index._replace(lists=store),
                   base=jnp.asarray(arrays["base"]),
                   config=JConfig(**cfg._asdict()))
    np.testing.assert_array_equal(np.asarray(jeng.live_bits),
                                  arrays["live_bits"])
    _assert_norms(jeng.base_norms, arrays["base_norms"])
    assert jeng.n_tombstones == teng.n_tombstones
    _assert_engines_agree(teng, jeng, _queries())


# ---------------------------------------------------------------------------
# concurrency: searches while one thread mutates
# ---------------------------------------------------------------------------

def _mutation_ops(seed=31, rounds=6):
    """A program of deletes and upserts over a pool of ids (cap and base
    keep their shapes), one op per epoch."""
    rng = np.random.default_rng(seed)
    ops, pool = [], np.arange(100, 400)
    for _ in range(rounds):
        sel = np.sort(rng.choice(pool, size=40, replace=False))
        ops.append(("delete", sel))
        ops.append(("upsert", sel, rng.normal(size=(40, D)).astype(
            np.float32)))
    return ops


def _apply(eng, op):
    if op[0] == "delete":
        eng.delete(op[1])
    else:
        eng.upsert(op[1], op[2])


def test_searches_during_mutation_see_one_epoch_each():
    """Ten threads (more than the cores) run search and search_jit while one
    thread deletes and upserts, with a short switch interval. Every result
    equals the result of one epoch, an epoch between the one before the
    call and the one after it (never a mix); ids deleted before the run
    never appear; epochs advance."""
    cfg = EngineConfig(nprobe=8, rerank_mult=2, scan_impl="stream",
                       rerank_impl="stream")
    q = _queries()
    pre_dead = np.arange(100)
    ops = _mutation_ops()
    serial = port_engine(cfg)
    serial.delete(pre_dead)
    per_epoch = {serial.epoch: serial.search(q, 5)}
    for op in ops:
        _apply(serial, op)
        per_epoch[serial.epoch] = serial.search(q, 5)
    eng = port_engine(cfg)
    eng.delete(pre_dead)
    epoch0 = eng.epoch
    errors, seen = [], []
    done = threading.Event()

    def reader(call):
        try:
            while not done.is_set():
                e0 = eng.epoch
                r = getattr(eng, call)(q, 5)
                e1 = eng.epoch
                hits = [e for e in range(e0, e1 + 1)
                        if torch.equal(r.ids, per_epoch[e].ids)
                        and torch.equal(r.dists, per_epoch[e].dists)
                        and all(torch.equal(a, b) for a, b in
                                zip(r.stats, per_epoch[e].stats))]
                if not hits:
                    errors.append((call, e0, e1))
                if set(r.ids.flatten().tolist()) & set(pre_dead.tolist()):
                    errors.append((call, "a deleted id came back", e0))
                seen.append(hits[0] if hits else -1)
        except Exception as exc:       # surface in the main thread
            errors.append(exc)
            done.set()

    readers = [threading.Thread(target=reader, args=(c,))
               for c in ("search", "search_jit") * 5]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in readers:
            t.start()
        for op in ops:
            n = len(seen)
            _apply(eng, op)
            while len(seen) < n + 2 and not done.is_set():
                done.wait(0.001)       # let readers search meanwhile
    finally:
        done.set()
        for t in readers:
            t.join(timeout=120)
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in readers)
    assert not errors, errors[:5]
    assert eng.epoch == epoch0 + len(ops)
    assert len(set(seen)) >= len(ops) // 2     # the epochs advanced
    np.testing.assert_array_equal(eng.search(q, 5).ids.numpy(),
                                  per_epoch[eng.epoch].ids.numpy())

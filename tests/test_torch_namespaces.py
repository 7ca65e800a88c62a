"""Namespaced search and attribute filters of the port, held against the
JAX reference on the CPU.

An index with a namespace table, built by ``repro.engine.SearchEngine``,
is carried over through ``interop`` (``ns_member`` included); both engines
answer the same numpy queries with the same per-query tenants. Ids must
match tie-aware, distances within rtol 1e-5 (cross-framework f32), every
``QueryStats`` counter exactly; filter bitmaps bit for bit.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lists as jlists
from repro.data import vectors as jvec
from repro.engine import EngineConfig as JConfig
from repro.engine import SearchEngine as JEngine
from repro_torch import interop
from repro_torch.core import lists as tlists
from repro_torch.engine import EngineConfig, SearchEngine

RTOL = 1e-5
NPROBE = 6
NLIST = 16
NQ = 12
CONFIGS = {
    "stream": dict(nprobe=NPROBE, scan_impl="stream", rerank_impl="stream"),
    "anytime": dict(nprobe=NPROBE, probe_policy="margin", margin_tau=0.4,
                    early_exit=True, scan_impl="stream",
                    rerank_impl="stream"),
}


def assert_tie_aware(got_v, got_i, want_v, want_i, rtol=RTOL):
    """Values within rtol; ids equal up to order inside runs of values
    within rtol of each other."""
    got_v, want_v = np.asarray(got_v), np.asarray(want_v)
    got_i, want_i = np.asarray(got_i), np.asarray(want_i)
    np.testing.assert_allclose(got_v, want_v, rtol=rtol)
    for q in range(want_v.shape[0]):
        i, k = 0, want_v.shape[1]
        while i < k:
            j = i + 1
            while j < k and np.isclose(want_v[q, j], want_v[q, j - 1],
                                       rtol=rtol):
                j += 1
            assert sorted(got_i[q, i:j]) == sorted(want_i[q, i:j]), (q, i, j)
            i = j


def assert_same_result(a, b):
    """Bitwise: dists, ids and every QueryStats field."""
    assert torch.equal(a.dists, b.dists) and torch.equal(a.ids, b.ids)
    for f in a.stats._fields:
        assert torch.equal(getattr(a.stats, f), getattr(b.stats, f)), f


def _member(seed=5):
    """Three tenants, each a share of the lists (6, 5, 5: two have fewer
    than nprobe), one list shared by tenants 0 and 1."""
    perm = np.random.default_rng(seed).permutation(NLIST)
    m = np.zeros((3, NLIST), bool)
    for t in range(3):
        m[t, perm[t::3]] = True
    m[1, perm[0]] = True
    return m


def _arrays(jeng):
    out = dict(jlists.store_arrays(jeng.index.lists))
    out["centroids"] = np.asarray(jeng.index.centroids)
    out["codebook"] = np.asarray(jeng.index.codebook.codewords)
    out["base"] = np.asarray(jeng.base)
    out["base_norms"] = np.asarray(jeng.base_norms)
    out["ns_member"] = np.asarray(jeng.ns_member)
    return out


@functools.lru_cache(maxsize=None)
def _dataset():
    return jvec.make_sift_like(n=3000, nt=1500, nq=NQ, d=32, ncl=16, seed=11)


@functools.lru_cache(maxsize=None)
def _jengine(path):
    ds = _dataset()
    built = JEngine.build(jax.random.PRNGKey(2), ds.train, ds.base, m=8,
                          nlist=NLIST, config=JConfig(**CONFIGS["stream"]),
                          coarse_iters=5, pq_iters=5)
    return JEngine(built.index, base=built.base,
                   config=JConfig(**CONFIGS[path]),
                   namespaces=jnp.asarray(_member()))


def _tengine(path):
    jeng = _jengine(path)
    return interop.engine_from_arrays(
        _arrays(jeng), config=EngineConfig(**jeng.config._asdict()),
        device="cpu")


def _tenants(seed=3):
    ns = np.random.default_rng(seed).integers(0, 3, NQ).astype(np.int32)
    ns[::4] = -1                                   # unrestricted queries
    return ns


def _fbits(jeng, seed=7):
    ids = np.asarray(jeng.index.lists.ids)
    mask = (np.random.default_rng(seed).random(ids.shape) < 0.5) & (ids >= 0)
    return np.asarray(jlists.pack_filter_mask(jnp.asarray(mask)))


@pytest.mark.parametrize("path", sorted(CONFIGS))
@pytest.mark.parametrize("filtered", [False, True])
@pytest.mark.parametrize("r", [0, 4])
def test_namespaced_search_equals_reference(path, filtered, r):
    jeng, teng = _jengine(path), _tengine(path)
    q = np.asarray(_dataset().queries)
    ns = _tenants()
    fb = _fbits(jeng) if filtered else None
    want = jeng.search_jit(jnp.asarray(q), 10, rerank_mult=r,
                           namespaces=jnp.asarray(ns),
                           filter_bits=None if fb is None
                           else jnp.asarray(fb))
    for entry in (teng.search, teng.search_jit):
        got = entry(q, 10, rerank_mult=r, namespaces=ns, filter_bits=fb)
        assert_tie_aware(got.dists, got.ids, want.dists, want.ids)
        for f in want.stats._fields:
            np.testing.assert_array_equal(
                getattr(got.stats, f).numpy(),
                np.asarray(getattr(want.stats, f)), err_msg=f)
    # a tenant with fewer lists than nprobe probes fewer
    assert int(got.stats.lists_probed.min()) < NPROBE


@pytest.mark.parametrize("path", sorted(CONFIGS))
def test_all_unrestricted_is_bitwise_the_namespace_free_result(path):
    teng = _tengine(path)
    q = np.asarray(_dataset().queries)
    free = teng.search(q, 10, rerank_mult=4)
    for entry in (teng.search, teng.search_jit):
        got = entry(q, 10, rerank_mult=4,
                    namespaces=np.full(NQ, -1, np.int32))
        assert_same_result(got, free)


def _ns_setup():
    """``tests/test_filtering.py::_ns_setup``'s layout: two tenants over 12
    lists (the first six, the last six)."""
    rng = np.random.default_rng(17)
    base = rng.standard_normal((1200, 32)).astype(np.float32)
    train = rng.standard_normal((1200, 32)).astype(np.float32)
    member = np.zeros((2, 12), bool)
    member[0, :6] = True
    member[1, 6:] = True
    eng = JEngine.build(
        jax.random.PRNGKey(1), train, base, m=8, nlist=12,
        config=JConfig(nprobe=4, rerank_mult=4, scan_impl="stream"),
        namespaces=jnp.asarray(member))
    ids_np = np.asarray(eng.index.lists.ids)
    owner = np.full(1200, -1)
    for li in range(12):
        live = ids_np[li][ids_np[li] >= 0]
        owner[live] = 0 if li < 6 else 1
    q = np.random.default_rng(23).normal(size=(5, 32)).astype(np.float32)
    ns = np.asarray([0, 1, -1, 0, 1], np.int32)
    return eng, owner, q, ns


def test_namespace_isolation_equals_reference():
    jeng, owner, q, ns = _ns_setup()
    teng = interop.engine_from_arrays(
        _arrays(jeng), config=EngineConfig(**jeng.config._asdict()),
        device="cpu")
    want = jeng.search(jnp.asarray(q), 10, namespaces=jnp.asarray(ns))
    for entry in (teng.search, teng.search_jit):
        got = entry(q, 10, namespaces=ns)
        assert_tie_aware(got.dists, got.ids, want.dists, want.ids)
        for qi, t in enumerate(ns):
            for gid in got.ids[qi].tolist():
                if gid >= 0 and t >= 0:
                    assert owner[gid] == t, f"namespace leak: q{qi} got {gid}"
    free = teng.search(q, 10)
    assert torch.equal(got.ids[2], free.ids[2])


def test_namespace_requests_are_validated_as_the_reference_does():
    jeng, teng = _jengine("stream"), _tengine("stream")
    q = np.asarray(_dataset().queries)
    # a 0-d tenant id is promoted to (1,)
    one = teng.search(q[0], 10, namespaces=np.int32(1))
    want = jeng.search(jnp.asarray(q[0]), 10, namespaces=jnp.int32(1))
    assert_tie_aware(one.dists, one.ids, want.dists, want.ids)
    with pytest.raises(ValueError, match="namespaces must be"):
        teng.search(q, 10, namespaces=np.zeros(NQ + 1, np.int32))
    with pytest.raises(ValueError, match="namespaces must be"):
        jeng.search(jnp.asarray(q), 10, namespaces=jnp.zeros(NQ + 1,
                                                             jnp.int32))
    bare = SearchEngine(teng.index)
    jbare = JEngine(jeng.index)
    for eng, qq in ((bare, q), (jbare, jnp.asarray(q))):
        with pytest.raises(ValueError, match="without a namespace table"):
            eng.search(qq, 10, namespaces=np.zeros(NQ, np.int32))
    bad = np.ones((2, NLIST - 1), bool)
    with pytest.raises(ValueError, match=f"nlist={NLIST}"):
        SearchEngine(teng.index, namespaces=bad)
    with pytest.raises(ValueError, match=f"nlist={NLIST}"):
        JEngine(jeng.index, namespaces=jnp.asarray(bad))


def test_interop_round_trip_carries_the_namespace_table():
    arrays = _arrays(_jengine("stream"))
    teng = _tengine("stream")
    assert teng.ns_member.dtype == torch.bool
    back = interop.arrays_from_engine(teng)
    assert sorted(back) == sorted(arrays)
    for key, val in arrays.items():
        np.testing.assert_array_equal(back[key], val, err_msg=key)


@pytest.mark.parametrize("cap", [32, 37])
def test_filter_from_attrs_equals_reference_bit_for_bit(cap):
    rng = np.random.default_rng(cap)
    n, nlist = 90, 5
    assign = rng.integers(0, nlist, n)
    packed = rng.integers(0, 256, (n, 2), np.uint8)
    attrs = rng.integers(0, 100, n).astype(np.int32)
    jstore = jlists.build_lists(assign, packed, nlist=nlist, cap=cap,
                               attrs=attrs)
    tstore = tlists.build_lists(assign, packed, nlist=nlist, cap=cap,
                                attrs=attrs, device="cpu")
    # the first predicate holds for the -1 sentinel of padded slots too
    for pred in (lambda a: a < 50, lambda a: a % 3 == 0, lambda a: a >= 0):
        want = np.asarray(jlists.filter_from_attrs(jstore, pred))
        got = tlists.filter_from_attrs(tstore, pred)
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), want)
        live = tlists.unpack_filter_mask(got, cap)
        assert not bool(live[tstore.ids < 0].any())
    bare = tlists.build_lists(assign, packed, nlist=nlist, cap=cap,
                              device="cpu")
    with pytest.raises(ValueError, match="attrs"):
        tlists.filter_from_attrs(bare, lambda a: a >= 0)

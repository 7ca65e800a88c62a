"""The port's serving path held against the JAX reference on the CPU.

An index built by ``repro.engine.SearchEngine.build`` is carried over to
``repro_torch`` through ``interop.engine_from_arrays``; both engines then
answer the same numpy queries. Ids must match tie-aware, distances within
rtol 1e-5 (cross-framework f32), and every ``QueryStats`` counter exactly.
The port's own build is held by recall, since torch cannot reproduce the
``jax.random`` k-means init.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ivf as jivf
from repro.core import lists as jlists
from repro.core import metrics as jmetrics
from repro.core import topk as jtopk
from repro.data import vectors as jvec
from repro.engine import EngineConfig as JConfig
from repro.engine import SearchEngine as JEngine
from repro_torch import interop
from repro_torch.core import ivf as tivf
from repro_torch.core import metrics as tmetrics
from repro_torch.core import topk as ttopk
from repro_torch.engine import EngineConfig, SearchEngine
from repro_torch.engine import rerank as trerank
from repro_torch.kernels import ops as tops

RTOL = 1e-5
NQ = 8          # queries per compared batch
NPROBE = 4


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


@pytest.fixture(scope="module")
def ds():
    return jvec.make_sift_like(n=2000, nt=1000, nq=64, d=32, ncl=16, seed=3)


@pytest.fixture(scope="module")
def jengine(ds):
    return JEngine.build(jax.random.PRNGKey(0), ds.train, ds.base, m=8,
                         nlist=16, config=JConfig(nprobe=NPROBE,
                                                  scan_impl="stream",
                                                  rerank_impl="stream"))


@pytest.fixture(scope="module")
def arrays(jengine):
    out = dict(jlists.store_arrays(jengine.index.lists))
    out["centroids"] = np.asarray(jengine.index.centroids)
    out["codebook"] = np.asarray(jengine.index.codebook.codewords)
    out["base"] = np.asarray(jengine.base)
    out["base_norms"] = np.asarray(jengine.base_norms)
    return out


@pytest.fixture(scope="module")
def tengine(arrays):
    return interop.engine_from_arrays(
        arrays, config=EngineConfig(nprobe=NPROBE, scan_impl="stream",
                                    rerank_impl="stream"), device="cpu")


@pytest.fixture(scope="module")
def fbits(arrays):
    rng = np.random.default_rng(7)
    ids = arrays["ids"]
    mask = (rng.random(ids.shape) < 0.5) & (ids >= 0)
    return np.asarray(jlists.pack_filter_mask(jnp.asarray(mask)))


@pytest.mark.parametrize("filtered", [False, True])
def test_scan_probes_stream_matches_reference_through_final_selection(
        jengine, tengine, ds, fbits, filtered):
    q = np.array(ds.queries[:NQ])
    keep = 12
    probes = np.array(jengine.coarse.search(jnp.asarray(q), NPROBE)[1])
    probes[1, 2] = -1                        # an invalid probe
    probes[2, 1] = probes[2, 0]              # and a duplicate probe
    fb = fbits if filtered else None
    jd, ji = jivf.scan_probes_stream(
        jengine.index, jnp.asarray(q), jnp.asarray(probes), keep=keep,
        filter_bits=None if fb is None else jnp.asarray(fb))
    td, ti = tivf.scan_probes_stream(
        tengine.index, torch.from_numpy(q), torch.from_numpy(probes),
        keep=keep, filter_bits=None if fb is None else torch.from_numpy(fb))
    assert td.shape == tuple(jd.shape) and ti.shape == tuple(ji.shape)
    wv, wp = jtopk.masked_topk(jd, ji >= 0, keep)
    gv, gp = ttopk.masked_topk(td, ti >= 0, keep)
    assert_tie_aware(gv, ttopk.gather_ids(ti, gp),
                     wv, jtopk.gather_ids(ji, wp))


@pytest.mark.parametrize("r", [0, 4])
@pytest.mark.parametrize("filtered", [False, True])
def test_search_jit_matches_reference(jengine, tengine, ds, fbits, r,
                                      filtered):
    q = np.asarray(ds.queries)[:NQ]
    fb = fbits if filtered else None
    want = jengine.search_jit(jnp.asarray(q), 10, rerank_mult=r,
                              filter_bits=None if fb is None
                              else jnp.asarray(fb))
    got = tengine.search_jit(q, 10, rerank_mult=r, filter_bits=fb)
    assert_tie_aware(got.dists, got.ids, want.dists, want.ids)
    assert got.ids.dtype == torch.int32 and got.dists.dtype == torch.float32
    for field in want.stats._fields:
        np.testing.assert_array_equal(getattr(got.stats, field).numpy(),
                                      np.asarray(getattr(want.stats, field)),
                                      err_msg=field)
    if filtered:
        assert int(got.stats.rows_filtered.sum()) > 0


def test_search_and_search_jit_are_the_same_pipeline(tengine, ds, fbits):
    q = np.asarray(ds.queries)[:NQ]
    a = tengine.search(q, 10, rerank_mult=4, filter_bits=fbits)
    b = tengine.search_jit(q, 10, rerank_mult=4, filter_bits=fbits)
    for x, y in zip(a[:2] + tuple(a.stats), b[:2] + tuple(b.stats)):
        assert torch.equal(x, y)
    one = tengine.search_jit(q[0], 10, rerank_mult=4)
    assert one.ids.shape == (1, 10)


def test_stream_rerank_equals_gathered_oracle(tengine, ds):
    """Inside the port the stream re-rank (plain K2 on the host) and the
    gathered ``exact_rerank`` share one distance expression."""
    rng = np.random.default_rng(0)
    q = torch.from_numpy(np.asarray(ds.queries)[:NQ])
    cand = torch.from_numpy(rng.integers(-1, 2000, (NQ, 37)).astype(np.int32))
    base, norms = tengine.base, tengine.base_norms
    wv, wi = trerank.exact_rerank(base, q, cand, 10, norms=norms)
    gv, gi = tops.rerank_stream_topk(base, norms, q, cand, k=10)
    assert torch.equal(gv, wv) and torch.equal(gi, wi)


def test_port_build_recall_is_close_to_reference(ds, jengine):
    q = np.asarray(ds.queries)
    gt = np.asarray(ds.gt_ids)
    ref = JEngine(jengine.index, base=ds.base, config=JConfig(nprobe=NPROBE))
    want = float(jmetrics.recall_at_r(
        ref.search(jnp.asarray(q), 10, rerank_mult=4).ids, jnp.asarray(gt),
        10))
    port = SearchEngine.build(np.asarray(ds.train), np.asarray(ds.base), m=8,
                              nlist=16,
                              config=EngineConfig(nprobe=NPROBE,
                                                  scan_impl="stream",
                                                  rerank_impl="stream"),
                              seed=0, device="cpu")
    assert port.index.lists.codes.shape[1:] == (port.index.cap, 4)
    got = float(tmetrics.recall_at_r(port.search(q, 10, rerank_mult=4).ids,
                                     torch.from_numpy(gt), 10))
    assert abs(got - want) <= 0.02, (got, want)


def test_build_without_device_needs_a_card(ds, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SearchEngine.build(np.asarray(ds.train), np.asarray(ds.base), m=8,
                           nlist=16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        interop.engine_from_arrays({})


def test_interop_round_trip(arrays, tengine):
    back = interop.arrays_from_engine(tengine)
    assert sorted(back) == sorted(arrays)
    for key, val in arrays.items():
        np.testing.assert_array_equal(back[key], val, err_msg=key)


def test_not_yet_ported_features_raise(tengine, arrays, ds):
    for cfg in (EngineConfig(scan_impl="simd"),
                EngineConfig(rerank_impl="exact")):
        with pytest.raises(ValueError, match="unknown"):
            SearchEngine(tengine.index, config=cfg)
    with pytest.raises(NotImplementedError, match="item 8"):
        SearchEngine(tengine.index).attach_wal(None)


def test_bad_requests_are_rejected(tengine, ds):
    q = np.asarray(ds.queries)[:2]
    with pytest.raises(ValueError, match="filter_bits"):
        tengine.search(q, 10, filter_bits=np.zeros((3, 1), np.uint8))
    no_base = SearchEngine(tengine.index)
    with pytest.raises(ValueError, match="base"):
        no_base.search(q, 10, rerank_mult=2)
    with pytest.raises(ValueError, match="rerank_mult"):
        SearchEngine(tengine.index, config=EngineConfig(rerank_mult=2))
    res = no_base.search(q, 10)
    assert int(res.stats.reranked.sum()) == 0

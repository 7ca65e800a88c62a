"""The graph cache behind ``search_jit``, off the card: its key, the CPU
path (eager, nothing captured) and the autotuner's refusal to sweep while a
stream captures. Graph replays themselves are card tests
(``tests/test_torch_cuda.py``)."""
import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.engine import EngineConfig, SearchEngine, fused_cache_size
from repro_torch.engine import graphs
from repro_torch.kernels import ops

NLIST, CAP, M, D = 8, 32, 8, 32
KNOBS = (10, 4, 0, "stream", "stream", "margin", True, 64, "flat")


def _engine(namespaces=True):
    rng = np.random.default_rng(0)
    arrays = {"codes": rng.integers(0, 256, (NLIST, CAP, M // 2), np.uint8),
              "ids": np.arange(NLIST * CAP, dtype=np.int32).reshape(NLIST,
                                                                    CAP),
              "sizes": np.full(NLIST, CAP, np.int32),
              "centroids": rng.normal(size=(NLIST, D)).astype(np.float32),
              "codebook": rng.normal(size=(M, 16, D // M)).astype(np.float32),
              "base": rng.normal(size=(NLIST * CAP, D)).astype(np.float32)}
    if namespaces:
        arrays["ns_member"] = rng.random((3, NLIST)) < 0.5
    cfg = EngineConfig(nprobe=4, probe_policy="margin", margin_tau=0.4,
                       early_exit=True, scan_impl="stream",
                       rerank_impl="stream")
    return interop.engine_from_arrays(arrays, config=cfg, device="cpu")


def _key(eng, q, fb=None, ns=None, tau=None, knobs=KNOBS):
    _, state = eng._bind(k=10, nprobe=4, r=0)
    return graphs.graph_key(q, (fb, ns, tau), knobs=knobs,
                            state=graphs.state_identity(state))


def test_graph_key_ignores_values_and_holds_shapes_knobs_presence_state():
    eng = _engine()
    assert eng._knobs(10, 4, 0) == KNOBS
    rng = np.random.default_rng(1)

    def t(shape, dtype=torch.float32):
        return torch.as_tensor(rng.integers(0, 3, shape)).to(dtype)

    fb = (NLIST, CAP // 8)
    base = _key(eng, t((8, D)), t(fb, torch.uint8), t((8,), torch.int32),
                t((8,)))
    # values of queries, filter, namespaces and tau never enter the key
    for _ in range(3):
        assert _key(eng, t((8, D)), t(fb, torch.uint8), t((8,), torch.int32),
                    t((8,))) == base
    q, f = t((8, D)), t(fb, torch.uint8)
    ns, tau = t((8,), torch.int32), t((8,))
    other = [
        _key(eng, t((9, D)), f, t((9,), torch.int32), t((9,))),   # Q
        _key(eng, t((8, D + 1)), f, ns, tau),                     # D
        _key(eng, q, None, ns, tau),                              # presence
        _key(eng, q, f, None, tau),
        _key(eng, q, f, ns, None),
        _key(eng, q, f, ns, t(())),                               # tau shape
    ]
    for i in range(len(KNOBS)):                                   # each knob
        knobs = list(KNOBS)
        knobs[i] = {int: 99, str: "select", bool: False}[type(KNOBS[i])]
        other.append(_key(eng, q, f, ns, tau, knobs=tuple(knobs)))
    assert base not in other and len(set(other)) == len(other)
    # the identity of every state tensor the graph reads
    for attr in ("base", "base_norms", "ns_member"):
        setattr(eng, attr, getattr(eng, attr).clone())
        now = _key(eng, q, f, ns, tau)
        assert now != base
        base = now
    lists = eng.index.lists
    eng.index = eng.index._replace(lists=lists._replace(
        codes=lists.codes.clone()))
    assert _key(eng, q, f, ns, tau) != base


def test_search_jit_on_the_cpu_captures_nothing_and_is_search():
    eng = _engine()
    q = np.random.default_rng(2).normal(size=(6, D)).astype(np.float32)
    ns = np.asarray([0, 1, 2, -1, 0, 1], np.int32)
    n0 = fused_cache_size()
    for kw in ({}, {"namespaces": ns}, {"margin_tau": np.full(6, 0.2)},
               {"rerank_mult": 4, "namespaces": ns}):
        a = eng.search(q, 5, **kw)
        b = eng.search_jit(q, 5, **kw)
        assert torch.equal(a.dists, b.dists) and torch.equal(a.ids, b.ids)
        for x, y in zip(a.stats, b.stats):
            assert torch.equal(x, y)
    assert fused_cache_size() == n0 and len(eng.graphs) == 0


def test_an_unresolved_verdict_raises_while_a_stream_captures(monkeypatch):
    ops.clear_autotune_cache()
    try:
        seen = ops.resolve_grouped_impl(8, 32, 8, device="cpu")
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                            lambda: True)
        # a resolved signature is served from the table
        assert ops.resolve_grouped_impl(8, 32, 8, device="cpu") == seen
        with pytest.raises(RuntimeError, match="not resolved before CUDA "
                                               "graph capture"):
            ops.resolve_grouped_impl(16, 32, 8, device="cpu")
        with pytest.raises(RuntimeError, match="'rerank'"):
            ops.resolve_rerank_impl(4, 40, D, 10, 256, device="cpu")
        assert ops.autotune_cache_size() == 1     # no sweep ran
    finally:
        ops.clear_autotune_cache()


def test_mutations_keep_the_state_identity_unless_they_reallocate():
    """The first write clones the tensors the engine was given, a new
    identity; after it, shape-keeping writes (delete, an upsert into spare
    slots, compaction at the same cap) go into the engine's tensors in
    place, so the identity a graph is keyed by stays; the live-row bitmap's
    presence keys the graph. Another cap or a larger base is a new
    identity."""
    rng = np.random.default_rng(3)
    ids = np.full((NLIST, CAP), -1, np.int32)
    ids[:, :CAP // 2] = np.arange(NLIST * CAP // 2).reshape(NLIST, -1)
    arrays = {"codes": rng.integers(0, 256, (NLIST, CAP, M // 2), np.uint8),
              "ids": ids, "sizes": np.full(NLIST, CAP // 2, np.int32),
              "centroids": rng.normal(size=(NLIST, D)).astype(np.float32),
              "codebook": rng.normal(size=(M, 16, D // M)).astype(np.float32),
              "base": rng.normal(size=(NLIST * CAP // 2, D)).astype(
                  np.float32)}
    eng = interop.engine_from_arrays(
        arrays, config=EngineConfig(nprobe=4, rerank_mult=2), device="cpu")
    q = torch.zeros((4, D))

    def key():
        _, state = eng._bind(k=10, nprobe=4, r=2)
        return graphs.graph_key(q, (None, None, None, eng.live_bits),
                                knobs=KNOBS,
                                state=graphs.state_identity(state))
    given = key()
    assert eng.compact() == 0          # the first write clones the tensors
    k0 = key()
    assert k0[-1] != given[-1] and k0[:-1] == given[:-1]
    assert eng.delete(np.arange(0, 40, 3)) == 14
    k1 = key()
    assert k1[-1] == k0[-1] and k1 != k0          # live bits now present
    eng.upsert(np.array([5, 40]), rng.normal(size=(2, D)))   # re-upserts
    assert key() == k1
    assert eng.compact() == 16 and eng.live_bits is None
    assert key() == k0
    eng.compact(cap=2 * CAP)                      # another cap
    k2 = key()
    assert k2[-1] != k0[-1]
    eng.upsert(np.array([NLIST * CAP]), rng.normal(size=(1, D)))
    assert eng.base.shape[0] == NLIST * CAP + 256
    assert key()[-1] != k2[-1]                    # the base grew
    assert eng.graphs_dropped == 0 and len(eng.graphs) == 0


@pytest.mark.parametrize("coarse", ["hnsw", "tree"])
def test_graph_key_holds_ef_the_coarse_kind_and_the_quantizers_tensors(
        coarse):
    """The HNSW beam width and the coarse kind are knobs of the key, and
    the quantizer's tensors are part of the state identity, so a graph
    never replays over another quantizer or beam."""
    flat = _engine()
    eng = SearchEngine(flat.index, base=flat.base, coarse=coarse,
                       config=flat.config, namespaces=flat.ns_member,
                       hnsw_m=4)
    knobs = eng._knobs(10, 4, 0)
    assert knobs[:-1] == KNOBS[:-1] and knobs[-1] == coarse
    if coarse == "hnsw":
        wider = SearchEngine(flat.index, base=flat.base, coarse=eng.coarse,
                             config=flat.config._replace(ef=32))
        assert wider._knobs(10, 4, 0)[7] == 32
    _, state = eng._bind(k=10, nprobe=4, r=0)
    ident = graphs.state_identity(state)
    tensors = eng.coarse.tensors()
    assert set(graphs.state_identity(tensors)) <= set(ident)
    eng.coarse = type(eng.coarse)(*(
        x.clone() if isinstance(x, torch.Tensor) else x
        for x in eng.coarse)) if coarse == "tree" else type(eng.coarse)(
        eng.coarse.graph._replace(level0=eng.coarse.graph.level0.clone()))
    _, state = eng._bind(k=10, nprobe=4, r=0)
    assert graphs.state_identity(state) != ident


@pytest.mark.parametrize("coarse", ["hnsw", "tree"])
def test_search_jit_on_the_cpu_is_search_for_each_quantizer(coarse):
    flat = _engine()
    eng = SearchEngine(flat.index, base=flat.base, coarse=coarse,
                       config=flat.config._replace(
                           ef=16 if coarse == "hnsw" else 64),
                       namespaces=flat.ns_member, hnsw_m=4)
    q = np.random.default_rng(4).normal(size=(6, D)).astype(np.float32)
    ns = np.asarray([0, 1, 2, -1, 0, 1], np.int32)
    n0 = fused_cache_size()
    for kw in ({}, {"namespaces": ns}, {"rerank_mult": 4}):
        a = eng.search(q, 5, **kw)
        b = eng.search_jit(q, 5, **kw)
        assert torch.equal(a.dists, b.dists) and torch.equal(a.ids, b.ids)
        for x, y in zip(a.stats, b.stats):
            assert torch.equal(x, y)
    assert fused_cache_size() == n0 and len(eng.graphs) == 0

"""The coarse zoo of the port (HNSW and the k-means tree) held against the
JAX reference on the CPU.

- ``build_hnsw`` is the reference's numpy build, kept in the port: the same
  rows and seed give the same graph arrays bit for bit.
- ``search_hnsw`` where no level-0 row is padded (nlist > 2·m): ids equal
  up to near ties, distances within rtol 1e-5 (each framework sums its own
  f32 squares). Where every row is padded (nlist <= 2·m) the reference
  marks node 0 unvisited again after each expansion and returns it more
  than once; the port returns distinct ids.
- ``TreeCoarse.search`` over the reference's roots and children, and the
  port's own tree by structure and recall (its k-means is seeded by torch,
  the reference's by ``jax.random``).
- HNSW and tree engines, namespaced too, carried over through ``interop``:
  ids tie-aware, distances within rtol 1e-5, all seven ``QueryStats``
  exact.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import coarse as jcoarse
from repro.core import hnsw as jhnsw
from repro.core import lists as jlists
from repro.data import vectors as jvec
from repro.engine import EngineConfig as JConfig
from repro.engine import SearchEngine as JEngine
from repro_torch import interop
from repro_torch.core import coarse as tcoarse
from repro_torch.core import hnsw as thnsw
from repro_torch.engine import EngineConfig, SearchEngine

RTOL = 1e-5
NLIST, HNSW_M, EF_C = 64, 8, 32
NQ = 16
CONFIGS = {
    "stream": dict(nprobe=6, rerank_mult=4, scan_impl="stream",
                   rerank_impl="stream"),
    "anytime": dict(nprobe=6, rerank_mult=4, probe_policy="margin",
                    margin_tau=0.4, early_exit=True, scan_impl="stream",
                    rerank_impl="stream"),
    "ref": dict(nprobe=4, rerank_mult=0, scan_impl="ref"),
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


def assert_stats_equal(got, want):
    for field in want.stats._fields:
        np.testing.assert_array_equal(getattr(got.stats, field).numpy(),
                                      np.asarray(getattr(want.stats, field)),
                                      err_msg=field)


def _rows(seed, n, d=16):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def _graph_arrays(g) -> dict:
    """A reference HNSW graph as interop arrays."""
    out = {"hnsw_vectors": np.asarray(g.vectors),
           "hnsw_level0": np.asarray(g.level0),
           "hnsw_entry": np.asarray(g.entry)}
    for lvl, (ids, adj) in enumerate(g.uppers, start=1):
        out[f"hnsw_ids_{lvl}"] = np.asarray(ids)
        out[f"hnsw_adj_{lvl}"] = np.asarray(adj)
    return out


def _port_graph(g) -> thnsw.HNSWGraph:
    return interop.coarse_from_arrays(_graph_arrays(g), "cpu").graph


# ---------------------------------------------------------------------------
# the graph
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,m,ef_c,seed", [(100, 4, 32, 0), (300, 4, 16, 1),
                                           (64, 8, 32, 2), (24, 16, 64, 3)])
def test_build_hnsw_is_bit_for_bit(n, m, ef_c, seed):
    x = _rows(seed, n)
    want = jhnsw.build_hnsw(x, m=m, ef_construction=ef_c, seed=seed)
    got = thnsw.build_hnsw(x, m=m, ef_construction=ef_c, seed=seed,
                           device="cpu")
    assert got.entry == want.entry and len(got.uppers) == len(want.uppers)
    np.testing.assert_array_equal(got.vectors.numpy(), np.asarray(want.vectors))
    np.testing.assert_array_equal(got.level0.numpy(), np.asarray(want.level0))
    for (gi, ga), (wi, wa) in zip(got.uppers, want.uppers):
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(ga.numpy(), np.asarray(wa))
    assert got.level0.dtype == torch.int32
    # the tensors a graph key reads, in a fixed order
    assert len(got.tensors()) == 2 + 2 * len(got.uppers)


@pytest.mark.parametrize("n,m,ef,topk", [(300, 4, 16, 8), (300, 4, 40, 10),
                                         (100, 4, 8, 4), (64, 8, 24, 6)])
def test_search_hnsw_matches_reference_without_padded_rows(n, m, ef, topk):
    x = _rows(7, n)
    g = jhnsw.build_hnsw(x, m=m, ef_construction=32)
    assert (np.asarray(g.level0) >= 0).all()          # nlist > 2·m here
    assert len(g.uppers) >= 1                         # the descent runs
    q = _rows(8, 24)
    wv, wi = jhnsw.search_hnsw(g, jnp.asarray(q), ef=ef, topk=topk)
    gv, gi = thnsw.search_hnsw(_port_graph(g), torch.from_numpy(q), ef=ef,
                               topk=topk)
    assert gi.dtype == torch.int32 and gv.shape == (24, topk)
    assert_tie_aware(gv, gi, wv, wi)


def test_padded_level0_rows_repeat_node_0_in_the_reference_only():
    """nlist <= 2·m: every level-0 row is padded. The reference's visited
    scatter writes a pad (-1, clamped to node 0) after the real neighbour 0
    with node 0's old flag, so node 0 stays unvisited and re-enters the
    beam at each expansion; the port marks real neighbours only."""
    x = _rows(11, 24)
    g = jhnsw.build_hnsw(x, m=16)
    assert (np.asarray(g.level0) < 0).any(axis=1).all()
    q = _rows(12, 64)
    _, wi = jhnsw.search_hnsw(g, jnp.asarray(q), ef=24, topk=8)
    gv, gi = thnsw.search_hnsw(_port_graph(g), torch.from_numpy(q), ef=24,
                               topk=8)
    wi, gi = np.asarray(wi), gi.numpy()
    repeats = [row for row in wi if len(set(row)) < len(row)]
    assert repeats, "the reference repeated no id"
    # what repeats is node 0, and only node 0
    for row in repeats:
        ids, counts = np.unique(row, return_counts=True)
        assert set(ids[counts > 1]) == {0}
    assert all(len(set(row)) == len(row) for row in gi)
    # the port's answer is the exact 8 nearest of the 24 points
    exact = np.argsort(((q[:, None] - x[None]) ** 2).sum(-1), axis=1,
                       kind="stable")[:, :8]
    assert (np.sort(gi, axis=1) == np.sort(exact, axis=1)).mean() > 0.95
    assert np.all(np.diff(gv.numpy(), axis=1) >= 0)


# ---------------------------------------------------------------------------
# the tree
# ---------------------------------------------------------------------------

def test_tree_search_over_the_reference_tree_matches():
    cen = _rows(21, NLIST)
    tree = jcoarse.build_tree(jax.random.PRNGKey(0), jnp.asarray(cen))
    port = interop.coarse_from_arrays(
        {"tree_roots": np.asarray(tree.roots),
         "tree_children": np.asarray(tree.children),
         "tree_centroids": np.asarray(tree.centroids)}, "cpu")
    assert isinstance(port, tcoarse.TreeCoarse)
    q = _rows(22, 20)
    for nprobe in (1, 5, 12):
        wv, wi = tree.search(jnp.asarray(q), nprobe)
        gv, gi = port.search(torch.from_numpy(q), nprobe)
        assert_tie_aware(gv, gi, wv, wi)


def test_port_tree_structure_and_recall():
    cen = torch.from_numpy(_rows(31, NLIST))
    tree = tcoarse.build_tree(cen)
    r = int(np.sqrt(NLIST))
    children = tree.children.numpy()
    assert tree.roots.shape == (r, cen.shape[1]) and children.shape[0] == r
    kids = children[children >= 0]
    # every centroid under exactly one root, each row ascending, -1 after
    np.testing.assert_array_equal(np.sort(kids), np.arange(NLIST))
    for row in children:
        real = row[row >= 0]
        assert (row[len(real):] == -1).all() and (np.diff(real) > 0).all()
    # the same seed gives the same tree
    again = tcoarse.build_tree(cen)
    assert torch.equal(again.children, tree.children)
    assert torch.equal(again.roots, tree.roots)
    # recall of the routed probes against the flat quantizer's
    q = torch.from_numpy(_rows(32, 200))
    _, want = tcoarse.build_flat(cen).search(q, 8)
    _, got = tree.search(q, 8)
    hit = np.mean([len(set(a) & set(b)) / 8.0
                   for a, b in zip(got.numpy(), want.numpy())])
    assert hit > 0.8, hit


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _ds():
    return jvec.make_deep_like(n=3000, nt=1500, nq=NQ, d=32, ncl=32, seed=4)


@functools.lru_cache(maxsize=None)
def _jengine(coarse: str, with_ns: bool = False):
    ds = _ds()
    ns = None
    if with_ns:
        perm = np.random.default_rng(5).permutation(NLIST)
        ns = np.zeros((3, NLIST), bool)
        for t in range(3):
            ns[t, perm[t::3]] = True
    return JEngine.build(jax.random.PRNGKey(0), jnp.asarray(ds.train),
                         jnp.asarray(ds.base), m=8, nlist=NLIST,
                         coarse=coarse, hnsw_m=HNSW_M, ef_construction=EF_C,
                         coarse_iters=6, pq_iters=6,
                         namespaces=None if ns is None else jnp.asarray(ns))


def _engine_arrays(jeng) -> dict:
    out = dict(jlists.store_arrays(jeng.index.lists))
    out["centroids"] = np.asarray(jeng.index.centroids)
    out["codebook"] = np.asarray(jeng.index.codebook.codewords)
    out["base"] = np.asarray(jeng.base)
    out["base_norms"] = np.asarray(jeng.base_norms)
    if jeng.ns_member is not None:
        out["ns_member"] = np.asarray(jeng.ns_member)
    if jeng.coarse_kind == "hnsw":
        out.update(_graph_arrays(jeng.coarse.graph))
    else:
        tree = jeng.coarse
        out.update({"tree_roots": np.asarray(tree.roots),
                    "tree_children": np.asarray(tree.children),
                    "tree_centroids": np.asarray(tree.centroids)})
    return out


def _pair(coarse, cfg_name, *, with_ns=False, ef=None):
    kw = dict(CONFIGS[cfg_name])
    if ef is not None:
        kw["ef"] = ef
    jeng = _jengine(coarse, with_ns)
    want = JEngine(jeng.index, base=jeng.base, coarse=jeng.coarse,
                   config=JConfig(**kw), namespaces=jeng.ns_member)
    got = interop.engine_from_arrays(_engine_arrays(jeng),
                                     config=EngineConfig(**kw), device="cpu")
    assert got.coarse_kind == coarse
    return want, got


@pytest.mark.parametrize("cfg_name", list(CONFIGS))
@pytest.mark.parametrize("coarse,ef", [("hnsw", None), ("hnsw", 16),
                                       ("tree", None)])
def test_engine_matches_reference(coarse, ef, cfg_name):
    want_eng, got_eng = _pair(coarse, cfg_name, ef=ef)
    q = np.asarray(_ds().queries)
    want = want_eng.search(jnp.asarray(q), 10)
    got = got_eng.search(q, 10)
    assert_tie_aware(got.dists, got.ids, want.dists, want.ids)
    assert_stats_equal(got, want)
    # search_jit on the CPU is search
    jit = got_eng.search_jit(q, 10)
    assert torch.equal(jit.ids, got.ids) and torch.equal(jit.dists, got.dists)


@pytest.mark.parametrize("coarse", ["hnsw", "tree"])
def test_namespaced_engine_matches_reference(coarse):
    """Probes outside a tenant's lists are masked after routing (-1), and a
    tenant past the table reads its last row."""
    want_eng, got_eng = _pair(coarse, "stream", with_ns=True)
    q = np.asarray(_ds().queries)
    ns = np.array([-1, 0, 1, 2, 5] * 4, np.int32)[:q.shape[0]]
    want = want_eng.search(jnp.asarray(q), 10, namespaces=jnp.asarray(ns))
    got = got_eng.search(q, 10, namespaces=ns)
    assert_tie_aware(got.dists, got.ids, want.dists, want.ids)
    assert_stats_equal(got, want)
    member = got_eng.ns_member.numpy()
    lists_of = {}
    ids = got_eng.index.lists.ids.numpy()
    for lst in range(NLIST):
        for g in ids[lst][ids[lst] >= 0]:
            lists_of[int(g)] = lst
    for row, t in zip(got.ids.numpy(), ns):
        if t >= 0:
            assert all(member[min(t, 2), lists_of[int(g)]]
                       for g in row if g >= 0)


def test_port_builds_the_reference_graph_from_the_same_centroids():
    jeng = _jengine("hnsw")
    arrays = _engine_arrays(jeng)
    for key in [k for k in arrays if k.startswith("hnsw_")]:
        del arrays[key]
    flat = interop.engine_from_arrays(arrays, device="cpu")
    eng = SearchEngine(flat.index, base=flat.base, coarse="hnsw",
                       hnsw_m=HNSW_M, ef_construction=EF_C)
    want = jeng.coarse.graph
    got = eng.coarse.graph
    assert got.entry == want.entry
    np.testing.assert_array_equal(got.level0.numpy(), np.asarray(want.level0))
    for (gi, ga), (wi, wa) in zip(got.uppers, want.uppers):
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(ga.numpy(), np.asarray(wa))
    # and carries it back out as the same arrays
    back = interop.arrays_from_engine(eng)
    for key, value in _graph_arrays(want).items():
        np.testing.assert_array_equal(back[key], value, err_msg=key)


def test_port_tree_engine_recall_beside_flat():
    jeng = _jengine("hnsw")
    arrays = _engine_arrays(jeng)
    for key in [k for k in arrays if k.startswith("hnsw_")]:
        del arrays[key]
    cfg = EngineConfig(**CONFIGS["stream"])
    flat = interop.engine_from_arrays(arrays, config=cfg, device="cpu")
    tree = SearchEngine(flat.index, base=flat.base, coarse="tree", config=cfg)
    assert tree.coarse_kind == "tree"
    q = np.asarray(_ds().queries)
    gt = np.asarray(_ds().gt_ids)[:, :10]

    def recall(res):
        return np.mean([len(set(a) & set(b)) / 10.0
                        for a, b in zip(res.ids.numpy(), gt)])
    assert recall(tree.search(q, 10)) >= recall(flat.search(q, 10)) - 0.1
    back = interop.arrays_from_engine(tree)
    again = interop.engine_from_arrays(back, config=cfg, device="cpu")
    assert again.coarse_kind == "tree"
    assert torch.equal(again.search(q, 10).ids, tree.search(q, 10).ids)


def test_coarse_arguments_are_checked():
    eng = interop.engine_from_arrays(
        {k: v for k, v in _engine_arrays(_jengine("tree")).items()
         if not k.startswith("tree_")}, device="cpu")
    with pytest.raises(ValueError, match="unknown coarse kind"):
        SearchEngine(eng.index, coarse="ivf")
    with pytest.raises(ValueError, match="ef"):
        SearchEngine(eng.index, coarse="tree", config=EngineConfig(ef=32))
    hnsw = SearchEngine(eng.index, coarse="hnsw", config=EngineConfig(ef=32),
                        hnsw_m=HNSW_M)
    assert hnsw.coarse_kind == "hnsw"


def test_a_custom_quantizer_runs_eagerly():
    """Any object with search(q, nprobe) routes; its kind is 'custom' and
    search_jit is search."""
    jeng = _jengine("tree")
    arrays = {k: v for k, v in _engine_arrays(jeng).items()
              if not k.startswith("tree_")}
    cfg = EngineConfig(**CONFIGS["stream"])
    flat = interop.engine_from_arrays(arrays, config=cfg, device="cpu")

    class Custom:
        def search(self, q, nprobe):
            return flat.coarse.search(q, nprobe)
    eng = SearchEngine(flat.index, base=flat.base, coarse=Custom(),
                       config=cfg, base_norms=flat.base_norms)
    assert eng.coarse_kind == "custom"
    q = np.asarray(_ds().queries)
    want = flat.search(q, 10)
    got = eng.search_jit(q, 10)
    assert torch.equal(got.ids, want.ids)
    assert torch.equal(got.dists, want.dists)

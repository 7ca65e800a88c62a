"""The port's anytime, autotuned serving path held against the reference.

Indexes built by ``repro`` are carried across with ``interop`` (or built
from raw numpy arrays on both sides), then both packages answer the same
numpy queries: the scan stage per impl, the early-exit stream scan through
the final selection, the margin + early-exit engine (ids tie-aware, dists
within rtol 1e-5, every ``QueryStats`` counter exact), and the autotuner
(cache keys, persistence across packages, failure propagation).
"""
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ivf as jivf
from repro.core import lists as jlists
from repro.core.lists import ListStore as JStore
from repro.core.pq import PQCodebook as JCodebook
from repro.core import topk as jtopk
from repro.data import vectors as jvec
from repro.engine import EngineConfig as JConfig
from repro.engine import SearchEngine as JEngine
from repro.engine import engine as jeng_mod
from repro.kernels import ops as jops
from repro_torch import interop
from repro_torch.core import ivf as tivf
from repro_torch.core import lists as tlists
from repro_torch.core import topk as ttopk
from repro_torch.engine import EngineConfig, SearchEngine
from repro_torch.engine import engine as teng
from repro_torch.engine import rerank as trerank
from repro_torch.kernels import ops as tops
from repro_torch.kernels import fastscan_kernel as tfk
from repro_torch.kernels import select_kernel as tsk
from repro_torch.kernels import stream_grouped_kernel as tsgk

RTOL = 1e-5
NPROBE = 8


def _t(x):
    return torch.from_numpy(np.array(x))


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


# ---------------------------------------------------------------------------
# indexes: synthetic (numpy, both sides) and built by repro
# ---------------------------------------------------------------------------

def _synth_arrays(nlist, cap, m, *, seed, skew=False):
    """Raw arrays of a full-occupancy index; with ``skew`` half the lists
    sit far from the origin, so early exit genuinely skips their tiles."""
    d = 4 * m
    rng = np.random.default_rng(seed)
    cen = rng.normal(size=(nlist, d)).astype(np.float32)
    if skew:
        cen[nlist // 2:] += 200.0
    return {"codes": rng.integers(0, 256, (nlist, cap, m // 2), np.uint8),
            "ids": np.arange(nlist * cap, dtype=np.int32).reshape(nlist, cap),
            "sizes": np.full(nlist, cap, np.int32), "centroids": cen,
            "codebook": rng.normal(size=(m, 16, d // m)).astype(np.float32)}


def _both_indexes(arrays):
    j = jivf.IVFIndex(centroids=jnp.asarray(arrays["centroids"]),
                      codebook=JCodebook(jnp.asarray(arrays["codebook"])),
                      lists=JStore(codes=jnp.asarray(arrays["codes"]),
                                   ids=jnp.asarray(arrays["ids"]),
                                   sizes=jnp.asarray(arrays["sizes"])))
    return j, interop.index_from_arrays(arrays, device="cpu")


@functools.lru_cache(maxsize=None)
def _dataset():
    return jvec.make_sift_like(n=4000, nt=1500, nq=8, d=32, ncl=16, seed=5)


@functools.lru_cache(maxsize=None)
def _jengine(probe_policy="margin", early_exit=True, scan_impl="stream",
             rerank_impl="stream", margin_tau=0.4):
    ds = _dataset()
    cfg = JConfig(nprobe=NPROBE, scan_impl=scan_impl, rerank_impl=rerank_impl,
                  probe_policy=probe_policy, early_exit=early_exit,
                  margin_tau=margin_tau)
    return JEngine.build(jax.random.PRNGKey(0), ds.train, ds.base, m=8,
                         nlist=16, config=cfg, coarse_iters=5, pq_iters=5)


def _arrays(jeng):
    out = dict(jlists.store_arrays(jeng.index.lists))
    out["centroids"] = np.asarray(jeng.index.centroids)
    out["codebook"] = np.asarray(jeng.index.codebook.codewords)
    out["base"] = np.asarray(jeng.base)
    out["base_norms"] = np.asarray(jeng.base_norms)
    return out


def _tengine(jeng):
    cfg = EngineConfig(**jeng.config._asdict())
    return interop.engine_from_arrays(_arrays(jeng), config=cfg, device="cpu")


def _fbits(jeng, seed=7):
    ids = np.asarray(jeng.index.lists.ids)
    mask = (np.random.default_rng(seed).random(ids.shape) < 0.5) & (ids >= 0)
    return np.asarray(jlists.pack_filter_mask(jnp.asarray(mask)))


# ---------------------------------------------------------------------------
# scan stage
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["ref", "select", "mxu", "stream"])
def test_scan_probes_equals_reference_per_impl(impl):
    jeng = _jengine()
    idx_t = _tengine(jeng).index
    q = np.asarray(_dataset().queries)
    probes = np.array(jeng.coarse.search(jnp.asarray(q), NPROBE)[1])
    probes[1, 3] = -1                                 # an invalid probe
    jd, ji = jivf.scan_probes(jeng.index, jnp.asarray(q), jnp.asarray(probes),
                              impl=impl)
    td, ti = tivf.scan_probes(idx_t, _t(q), _t(probes), impl=impl)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    real = ti.numpy() >= 0
    np.testing.assert_allclose(td.numpy()[real], np.asarray(jd)[real],
                               rtol=RTOL)


def test_scan_probes_impls_agree_inside_the_port():
    idx_j, idx_t = _both_indexes(_synth_arrays(6, 72, 8, seed=3))
    rng = np.random.default_rng(4)
    q = _t(rng.normal(size=(3, 32)).astype(np.float32))
    probes = _t(np.array([[0, 2, -1], [5, 5, 1], [3, 4, 0]], np.int32))
    want_d, want_i = tivf.scan_probes(idx_t, q, probes, impl="ref")
    real = want_i >= 0
    for impl in ("select", "mxu", "stream"):
        d, i = tivf.scan_probes(idx_t, q, probes, impl=impl)
        assert torch.equal(i, want_i)
        assert torch.equal(d[real], want_d[real])


@pytest.mark.parametrize("skew", [False, True])
@pytest.mark.parametrize("filtered", [False, True])
def test_scan_probes_stream_early_exit_equals_reference(skew, filtered):
    nlist, cap, m, tile, keep = 8, 64, 8, 16, 4
    arrays = _synth_arrays(nlist, cap, m, seed=11, skew=skew)
    idx_j, idx_t = _both_indexes(arrays)
    rng = np.random.default_rng(12)
    q = rng.normal(size=(2, 4 * m)).astype(np.float32)
    probes = np.tile(np.arange(nlist, dtype=np.int32), (2, 1))
    probes[1, 3] = -1
    fb = None
    if filtered:
        fb = np.asarray(jlists.pack_filter_mask(
            jnp.asarray(rng.random((nlist, cap)) < 0.5)))
    jd, ji, jsk = jivf.scan_probes_stream(
        idx_j, jnp.asarray(q), jnp.asarray(probes), keep=keep, tile_n=tile,
        filter_bits=None if fb is None else jnp.asarray(fb), early_exit=True)
    td, ti, tsk_ = tivf.scan_probes_stream(
        idx_t, _t(q), _t(probes), keep=keep, tile_n=tile,
        filter_bits=None if fb is None else _t(fb), early_exit=True)
    np.testing.assert_array_equal(tsk_.numpy(), np.asarray(jsk))
    if skew:
        assert int(tsk_.sum()) > 0
    wv, wp = jtopk.masked_topk(jd, ji >= 0, keep)
    gv, gp = ttopk.masked_topk(td, ti >= 0, keep)
    assert_tie_aware(gv, ttopk.gather_ids(ti, gp), wv,
                     jtopk.gather_ids(ji, wp))
    # lossless: the same selection as without early exit
    bd, bi = tivf.scan_probes_stream(idx_t, _t(q), _t(probes), keep=keep,
                                     tile_n=tile,
                                     filter_bits=None if fb is None
                                     else _t(fb))
    bv, bp = ttopk.masked_topk(bd, bi >= 0, keep)
    assert torch.equal(bv, gv)
    assert torch.equal(ttopk.gather_ids(bi, bp), ttopk.gather_ids(ti, gp))


def test_search_ivf_equals_reference():
    jeng = _jengine()
    idx_t = _tengine(jeng).index
    q = np.asarray(_dataset().queries)
    wv, wi = jivf.search_ivf(jeng.index, jnp.asarray(q), nprobe=4, topk=10)
    gv, gi = tivf.search_ivf(idx_t, _t(q), nprobe=4, topk=10)
    assert_tie_aware(gv, gi, wv, wi)
    probes = np.array(jeng.coarse.search(jnp.asarray(q), 6)[1])
    wv, wi = jivf.search_ivf_precomputed_probes(
        jeng.index, jnp.asarray(q), jnp.asarray(probes), nprobe=5, topk=10)
    gv, gi = tivf.search_ivf_precomputed_probes(idx_t, _t(q), _t(probes),
                                                nprobe=5, topk=10)
    assert_tie_aware(gv, gi, wv, wi)
    one = tivf.search_ivf(idx_t, _t(q[0]), nprobe=4, topk=3)
    assert one[1].shape == (1, 3)


# ---------------------------------------------------------------------------
# the engine: margin policy + early exit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("r", [0, 4])
@pytest.mark.parametrize("filtered", [False, True])
def test_margin_early_exit_engine_equals_reference(r, filtered):
    jeng = _jengine()
    teng_ = _tengine(jeng)
    q = np.asarray(_dataset().queries)
    fb = _fbits(jeng) if filtered else None
    for tau in (None, 0.0, 0.4, 2.0, np.inf):
        want = jeng.search_jit(jnp.asarray(q), 10, rerank_mult=r,
                               filter_bits=None if fb is None
                               else jnp.asarray(fb), margin_tau=tau)
        got = teng_.search_jit(q, 10, rerank_mult=r, filter_bits=fb,
                               margin_tau=tau)
        assert_tie_aware(got.dists, got.ids, want.dists, want.ids)
        assert_stats_equal(got, want)
    # both anytime mechanisms fire on this data: small tau prunes lists,
    # and with every probe kept early exit skips tiles
    assert int(teng_.search_jit(q, 10, margin_tau=0.0)
               .stats.lists_pruned.sum()) > 0
    assert int(teng_.search_jit(q, 10, margin_tau=np.inf)
               .stats.tiles_skipped.sum()) > 0


def test_per_query_margin_tau_equals_reference():
    jeng = _jengine()
    teng_ = _tengine(jeng)
    q = np.asarray(_dataset().queries)
    taus = np.linspace(0.0, 1.0, q.shape[0]).astype(np.float32)
    want = jeng.search_jit(jnp.asarray(q), 10, rerank_mult=4,
                           margin_tau=jnp.asarray(taus))
    got = teng_.search_jit(q, 10, rerank_mult=4, margin_tau=taus)
    assert_tie_aware(got.dists, got.ids, want.dists, want.ids)
    assert_stats_equal(got, want)
    with pytest.raises(ValueError, match="margin_tau must be"):
        teng_.search(q, 10, margin_tau=np.zeros(3, np.float32))


@pytest.mark.parametrize("scan_impl", ["ref", "select", "mxu", "auto"])
def test_gathered_and_auto_engines_equal_reference(scan_impl):
    """Under a gathered impl early exit is a no-op (zero tiles_skipped on
    both sides); 'auto' may pick differently in the two packages, so its
    skip counter is not compared."""
    jeng = _jengine(scan_impl="stream" if scan_impl == "auto" else scan_impl,
                    rerank_impl="gathered")
    cfg = EngineConfig(**dict(jeng.config._asdict(), scan_impl=scan_impl))
    teng_ = interop.engine_from_arrays(_arrays(jeng), config=cfg,
                                       device="cpu")
    q = np.asarray(_dataset().queries)
    try:
        want = jeng.search_jit(jnp.asarray(q), 10, rerank_mult=2)
        got = teng_.search_jit(q, 10, rerank_mult=2)
    finally:
        tops.clear_autotune_cache()
    assert_tie_aware(got.dists, got.ids, want.dists, want.ids)
    for field in want.stats._fields:
        if scan_impl == "auto" and field == "tiles_skipped":
            continue
        np.testing.assert_array_equal(getattr(got.stats, field).numpy(),
                                      np.asarray(getattr(want.stats, field)),
                                      err_msg=field)


def test_margin_tau_inf_is_bitwise_fixed_and_early_exit_lossless():
    jeng = _jengine()
    adp = _tengine(jeng)
    fixed = SearchEngine(adp.index, base=adp.base, base_norms=adp.base_norms,
                         config=adp.config._replace(probe_policy="fixed",
                                                    early_exit=False))
    no_ee = SearchEngine(adp.index, base=adp.base, base_norms=adp.base_norms,
                         config=adp.config._replace(early_exit=False))
    q = np.asarray(_dataset().queries)
    a = adp.search_jit(q, 10, rerank_mult=4, margin_tau=float("inf"))
    b = fixed.search_jit(q, 10, rerank_mult=4)
    assert torch.equal(a.ids, b.ids) and torch.equal(a.dists, b.dists)
    assert not a.stats.lists_pruned.any()
    for tau in (0.0, 0.4):
        x = adp.search_jit(q, 10, margin_tau=tau)
        y = no_ee.search_jit(q, 10, margin_tau=tau)
        assert torch.equal(x.ids, y.ids) and torch.equal(x.dists, y.dists)
        assert torch.equal(x.stats.lists_pruned, y.stats.lists_pruned)
        assert not y.stats.tiles_skipped.any()
    with pytest.raises(ValueError, match="probe_policy"):
        fixed.search(q, 10, margin_tau=0.5)


def test_stage_methods_equal_reference():
    jeng = _jengine()
    teng_ = _tengine(jeng)
    q = np.asarray(_dataset().queries)
    want_p = np.asarray(jeng.select_probes(jnp.asarray(q), NPROBE))
    got_p = teng_.select_probes(q, NPROBE)
    np.testing.assert_array_equal(got_p.numpy(), want_p)
    assert (want_p < 0).any()                 # margin_tau=0.4 pruned some
    wd, wi = jeng.scan(jnp.asarray(q), jnp.asarray(want_p))
    gd, gi = teng_.scan(q, got_p)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    real = gi.numpy() >= 0
    np.testing.assert_allclose(gd.numpy()[real], np.asarray(wd)[real],
                               rtol=RTOL)


def test_interop_carries_a_margin_early_exit_engine_unchanged():
    jeng = _jengine()
    arrays = _arrays(jeng)
    teng_ = _tengine(jeng)
    assert teng_.config == EngineConfig(**jeng.config._asdict())
    back = interop.arrays_from_engine(teng_)
    assert sorted(back) == sorted(arrays)
    for key, val in arrays.items():
        np.testing.assert_array_equal(back[key], val, err_msg=key)


def test_config_defaults_are_the_references():
    assert EngineConfig() == EngineConfig(**JConfig()._asdict())
    assert teng.PROBE_POLICIES == ("fixed", "margin")
    assert teng.MARGIN_PROBE_FILL == 0.5


# ---------------------------------------------------------------------------
# the autotuner
# ---------------------------------------------------------------------------

@pytest.fixture
def clean_cache():
    tops.clear_autotune_cache()
    jops.clear_autotune_cache()
    yield
    tops.clear_autotune_cache()
    jops.clear_autotune_cache()


def test_auto_resolves_deterministically_and_keys_by_fill(clean_cache):
    t1 = tops.resolve_grouped_impl(8, 32, 8, nlist=16, device="cpu")
    assert t1.impl in tops.GROUPED_IMPLS
    assert len(t1.timings_us) >= len(tops.GROUPED_IMPLS)
    assert tops.resolve_grouped_impl(8, 32, 8, nlist=16, device="cpu") is t1
    t_half = tops.resolve_grouped_impl(8, 32, 8, nlist=16, probe_fill=0.5,
                                       device="cpu")
    assert tops.autotune_cache_size() == 2
    assert tops.autotune_cache()[("scan", "cpu", False, 8, 32, 8, 16, 0.5)] \
        is t_half
    for bad in (0.0, 1.5):
        with pytest.raises(ValueError, match="probe_fill"):
            tops.resolve_grouped_impl(8, 32, 8, probe_fill=bad, device="cpu")
    # 'auto' dispatch equals 'ref' and reuses the gathered signature's entry
    rng = np.random.default_rng(2)
    table = _t(rng.integers(0, 256, (8, 8, 16), np.uint8))
    codes = _t(rng.integers(0, 256, (8, 32, 4), np.uint8))
    assert torch.equal(tops.fastscan_grouped(table, codes, impl="auto"),
                       tops.fastscan_grouped(table, codes, impl="ref"))
    assert tops.autotune_cache_size() == 3


def test_clear_autotune_cache_is_selective(clean_cache):
    tops.resolve_grouped_impl(4, 16, 4, nlist=8, device="cpu")
    tops.resolve_grouped_impl(4, 32, 4, nlist=8, device="cpu")
    tops.resolve_rerank_impl(2, 8, 8, 2, 100, device="cpu")
    assert tops.autotune_cache_size() == 3
    assert tops.clear_autotune_cache(cap=16) == 1
    assert tops.clear_autotune_cache(n=999) == 0
    assert tops.clear_autotune_cache(kind="rerank") == 1
    assert [k[4] for k in tops.autotune_cache()] == [32]
    assert tops.clear_autotune_cache() == 1


def test_autotune_files_carry_across_packages(clean_cache, tmp_path):
    tops.resolve_grouped_impl(8, 32, 8, nlist=16, probe_fill=0.5,
                              device="cpu")
    tops.resolve_rerank_impl(2, 8, 16, 2, 512, sweep_n_cap=64, device="cpu")
    port_file = str(tmp_path / "port.json")
    assert tops.save_autotune_cache(port_file) == 2
    data = json.loads(open(port_file).read())
    assert data["schema"] == "repro.autotune/v3"
    assert {e["backend"] for e in data["entries"]} == {"cpu"}
    assert not any(e["interpret"] for e in data["entries"])
    assert jops.load_autotune_cache(port_file) == 2
    assert set(jops.autotune_cache()) == set(tops.autotune_cache())

    # the reverse: the reference's own file loads in the port
    jops.clear_autotune_cache()
    jops.resolve_grouped_impl(8, 32, 8, nlist=16, probe_fill=0.5)
    ref_file = str(tmp_path / "ref.json")
    assert jops.save_autotune_cache(ref_file) == 1
    tops.clear_autotune_cache()
    assert tops.load_autotune_cache(ref_file) == 1
    (key,) = tops.autotune_cache()
    assert key == next(iter(jops.autotune_cache()))

    # v2 (no probe_fill) and v1 (no kind, no nlist) files migrate
    e2 = dict(data["entries"][0])
    assert e2["kind"] == "scan"
    e2.pop("probe_fill")
    p2 = tmp_path / "v2.json"
    p2.write_text(json.dumps({"schema": "repro.autotune/v2",
                              "entries": [e2]}))
    tops.clear_autotune_cache()
    assert tops.load_autotune_cache(str(p2)) == 1
    tops.resolve_grouped_impl(8, 32, 8, nlist=16, device="cpu")  # a hit
    assert tops.autotune_cache_size() == 1
    e1 = {k: e2[k] for k in ("backend", "interpret", "g", "cap", "m",
                             "impl", "tile_n", "timings_us")}
    p1 = tmp_path / "v1.json"
    p1.write_text(json.dumps({"schema": "repro.autotune/v1",
                              "entries": [e1]}))
    tops.clear_autotune_cache()
    assert tops.load_autotune_cache(str(p1)) == 1
    tops.resolve_grouped_impl(8, 32, 8, nlist=8, device="cpu")   # nlist=g
    assert tops.autotune_cache_size() == 1
    assert tops.load_autotune_cache(str(tmp_path / "missing.json")) == 0


def test_sweep_propagates_launch_failures_and_drops_shape_rejections(
        clean_cache, monkeypatch):
    def fails(*args, **kwargs):
        raise RuntimeError("fastscan_select_grouped: CUDA error 700")
    monkeypatch.setattr(tsk, "fastscan_select_tree_grouped", fails)
    with pytest.raises(RuntimeError, match="CUDA error"):
        tops.resolve_grouped_impl(4, 32, 4, nlist=8, device="cpu")
    assert tops.autotune_cache_size() == 0

    def rejects(*args, **kwargs):
        raise ValueError("tile too large for shared memory")
    monkeypatch.setattr(tsk, "fastscan_select_tree_grouped", rejects)
    tuned = tops.resolve_grouped_impl(4, 32, 4, nlist=8, device="cpu")
    names = [name for name, _ in tuned.timings_us]
    assert not any(n.startswith("select@") for n in names)
    assert any(n.startswith("mxu@") for n in names) and tuned.impl != "select"


def test_stream_candidates_time_the_per_tile_topk_scan(clean_cache,
                                                        monkeypatch):
    """A 'stream' verdict runs the per-tile top-kc scan (K1, or K4 with
    early exit) at its tile, so the sweep times K1 at each stream tile with
    the stand-in budget, and never the full-pool K3, which ignores its
    tile."""
    calls = []
    real = tfk.fastscan_stream_topk_grouped

    def spy(*args, **kwargs):
        calls.append((kwargs["tile_n"], kwargs["kc"]))
        return real(*args, **kwargs)

    def k3(*args, **kwargs):
        raise AssertionError("the sweep timed K3")
    monkeypatch.setattr(tfk, "fastscan_stream_topk_grouped", spy)
    monkeypatch.setattr(tsgk, "fastscan_stream_grouped", k3)
    cap = 2048
    tuned = tops.resolve_grouped_impl(4, cap, 4, nlist=8, device="cpu")
    tiles = sorted(int(name.split("@")[1]) for name, _ in tuned.timings_us
                   if name.startswith("stream@"))
    want = sorted({tops._stream_tile(cap, t)
                   for t in tops._grouped_tile_candidates(cap)})
    assert tiles == want == [128, 512, 1024]
    assert sorted({tile for tile, _ in calls}) == want
    assert {(tile, kc) for tile, kc in calls} == {
        (tile, min(tops._SWEEP_KEEP, tile)) for tile in want}


def test_gathered_candidates_time_their_gather(clean_cache, monkeypatch):
    """A gathered verdict runs ``ListStore.gather`` before its scan, so the
    sweep times each 'ref', 'select' and 'mxu' candidate on the copy its
    own gather made, and every candidate's pool goes through the same
    selection of the stand-in budget."""
    made, scanned, selected = set(), [], []
    gather = tlists.ListStore.gather
    grouped = tops.fastscan_grouped
    topk = tops.topk_mod.masked_topk

    def gather_spy(self, probe_ids):
        codes, ids = gather(self, probe_ids)
        made.add(codes.data_ptr())
        return codes, ids

    def grouped_spy(table, codes, **kwargs):
        scanned.append((kwargs["impl"], codes.data_ptr() in made))
        return grouped(table, codes, **kwargs)

    def topk_spy(d, valid, k):
        selected.append(k)
        return topk(d, valid, k)
    monkeypatch.setattr(tlists.ListStore, "gather", gather_spy)
    monkeypatch.setattr(tops, "fastscan_grouped", grouped_spy)
    monkeypatch.setattr(tops.topk_mod, "masked_topk", topk_spy)
    tuned = tops.resolve_grouped_impl(4, 256, 4, nlist=8, device="cpu")
    assert {impl for impl, _ in scanned} == {"ref", "select", "mxu"}
    assert all(fresh for _, fresh in scanned)
    assert any(name.startswith("stream@") for name, _ in tuned.timings_us)
    # the stream candidates' pools are selected too
    assert len(selected) > len(scanned)
    assert set(selected) == {tops._SWEEP_KEEP}


def test_rerank_sweep_cap_env_and_kwarg(clean_cache, monkeypatch):
    monkeypatch.delenv("REPRO_RERANK_SWEEP_N_CAP", raising=False)
    assert tops._rerank_sweep_n_cap() == tops._RERANK_SWEEP_N_CAP
    for raw, want in (("2048", 2048), ("x", tops._RERANK_SWEEP_N_CAP),
                      ("0", tops._RERANK_SWEEP_N_CAP)):
        monkeypatch.setenv("REPRO_RERANK_SWEEP_N_CAP", raw)
        assert tops._rerank_sweep_n_cap() == want
    t = tops.resolve_rerank_impl(2, 4, 16, 2, 512, sweep_n_cap=64,
                                 device="cpu")
    assert t.impl in tops.RERANK_CONCRETE
    tops.resolve_rerank_impl(2, 4, 16, 2, 512, sweep_n_cap=128, device="cpu")
    assert tops.autotune_cache_size() == 1


def test_finalize_candidates_equal_under_every_rerank_impl(clean_cache):
    jeng = _jengine()
    teng_ = _tengine(jeng)
    rng = np.random.default_rng(0)
    q = _t(np.asarray(_dataset().queries))
    flat_ids = _t(rng.integers(-1, 4000, (q.shape[0], 90)).astype(np.int32))
    flat_d = torch.where(flat_ids >= 0,
                         _t(rng.random(flat_ids.shape).astype(np.float32)),
                         torch.inf)
    outs = [trerank.finalize_candidates(flat_d, flat_ids, teng_.base, q, 10,
                                        4, norms=teng_.base_norms,
                                        rerank_impl=impl)
            for impl in ("gathered", "stream", "auto")]
    for other in outs[1:]:
        for a, b in zip(outs[0], other):
            assert torch.equal(a, b)
    assert tops.autotune_cache_size() == 1


def test_scan_candidates_gathered_early_exit_is_noop():
    """A gathered impl ignores early exit (zero counter); the stream path
    with it selects the same top-keep."""
    idx_j, idx_t = _both_indexes(_synth_arrays(5, 64, 8, seed=9))
    rng = np.random.default_rng(10)
    q = _t(rng.normal(size=(2, 32)).astype(np.float32))
    probes = _t(np.array([[0, 2], [4, 1]], np.int32))
    d_ref, i_ref, ts_ref = teng.scan_candidates(
        idx_t, q, probes, scan_impl="ref", keep=5, early_exit=True)
    assert not ts_ref.any() and ts_ref.shape == (2,)
    d_st, i_st, ts_st = teng.scan_candidates(
        idx_t, q, probes, scan_impl="stream", keep=5, early_exit=True)
    assert ts_st.shape == (2,)
    wv, wp = ttopk.masked_topk(d_ref, i_ref >= 0, 5)
    gv, gp = ttopk.masked_topk(d_st, i_st >= 0, 5)
    assert torch.equal(gv, wv)
    assert torch.equal(ttopk.gather_ids(i_st, gp), ttopk.gather_ids(i_ref, wp))
    # the reference's stage agrees on the full pool's selection
    jd, ji, _ = jeng_mod.scan_candidates(
        idx_j, jnp.asarray(q.numpy()), jnp.asarray(probes.numpy()),
        scan_impl="ref", keep=5, early_exit=True)
    jv, jp = jtopk.masked_topk(jd, ji >= 0, 5)
    assert_tie_aware(gv, ttopk.gather_ids(i_st, gp), jv,
                     jtopk.gather_ids(ji, jp))

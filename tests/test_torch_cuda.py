"""The port's CUDA kernels and engine on the card, held against the port's
own plain PyTorch versions and host pipeline.

Every test here carries the ``cuda`` marker and skips inside the test when
no card is present. The module imports neither jax nor the JAX package, so
it runs on a machine that has only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

(``--noconftest`` because ``tests/conftest.py`` imports jax.)
"""
import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.core.lists import pack_filter_mask
from repro_torch.data.vectors import make_sift_like
from repro_torch.engine import EngineConfig, SearchEngine
from repro_torch.kernels import _build
from repro_torch.kernels import fastscan_kernel as fk
from repro_torch.kernels import mxu_kernel as mk
from repro_torch.kernels import ops
from repro_torch.kernels import rerank_kernel as rk
from repro_torch.kernels import select_kernel as sk
from repro_torch.kernels import stream_grouped_kernel as sgk
from repro_torch.kernels import stream_prune_kernel as spk

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _k1_inputs(seed, dev, *, g, nlist, cap, mh, fill, invalid=0.1):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 256, (nlist, cap, mh), dtype=np.uint8)
    table = rng.integers(0, 256, (g, 2 * mh, 16), dtype=np.uint8)
    sizes = rng.integers(0, cap + 1, nlist).astype(np.int32)
    probes = rng.integers(0, nlist, g).astype(np.int32)
    probes[rng.random(g) < invalid] = -1
    bits = None
    if fill is not None:
        mask = torch.as_tensor(rng.random((nlist, cap)) < fill)
        bits = pack_filter_mask(mask).to(dev)
    return (*(torch.as_tensor(a, device=dev)
              for a in (table, codes, probes, sizes)), bits)


# (g, nlist, cap, mh, tile, kc, filter fill, invalid-probe share)
K1_CASES = [(1, 3, 64, 4, 64, 5, None, 0.0),
            (8, 5, 64, 3, 32, 7, 0.5, 0.1),       # odd M/2: byte loads
            (8, 5, 100, 4, 100, 9, 0.5, 0.1),     # non-power-of-two tile
            (64, 16, 4096, 8, 1024, 40, 0.5, 0.05),
            (16, 4, 8192, 8, 8192, 40, None, 0.0),  # one 64 KiB-key tile
            (4, 2, 64, 8, 16, 16, 1.0, 1.0)]       # every probe invalid


@pytest.mark.parametrize("case", range(len(K1_CASES)))
def test_k1_kernel_equals_plain(dev, case):
    g, nlist, cap, mh, tile, kc, fill, invalid = K1_CASES[case]
    table, codes, probes, sizes, bits = _k1_inputs(
        case, dev, g=g, nlist=nlist, cap=cap, mh=mh, fill=fill,
        invalid=invalid)
    n0 = fk.launches
    got = fk.fastscan_stream_topk_grouped(table, codes, probes, sizes, kc=kc,
                                          tile_n=tile, filter_bits=bits)
    torch.cuda.synchronize()
    assert fk.launches == n0 + 1
    want = fk.fastscan_stream_topk_plain(table, codes, probes, sizes, kc=kc,
                                         tile_n=tile, filter_bits=bits)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _k2_inputs(seed, dev, *, n, d, q, rp, integer):
    rng = np.random.default_rng(seed)
    if integer:
        base = rng.integers(-4, 5, (n, d)).astype(np.float32)
        qv = rng.integers(-4, 5, (q, d)).astype(np.float32)
        base[1] = base[0]
    else:
        base = rng.normal(size=(n, d)).astype(np.float32)
        qv = rng.normal(size=(q, d)).astype(np.float32)
    cand = rng.integers(0, n, (q, rp)).astype(np.int32)
    cand[rng.random((q, rp)) < 0.2] = -1
    cand[0, :3] = [0, 1, 0]
    cand[1] = -1
    base_t, q_t, cand_t = (torch.as_tensor(a, device=dev)
                           for a in (base, qv, cand))
    xn = (base_t * base_t).sum(-1)[cand_t.clamp_min(0).long()].contiguous()
    return base_t, q_t, cand_t, xn


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("d,rp,tile,k", [(128, 64, 64, 10), (128, 128, 32, 10),
                                         (30, 16, 8, 20)])
def test_k2_kernel_matches_plain(dev, integer, d, rp, tile, k):
    base, q, cand, xn = _k2_inputs(d + rp, dev, n=500, d=d, q=6, rp=rp,
                                   integer=integer)
    n0 = rk.launches
    gv, gp = rk.rerank_stream_topk(base, q, cand, xn, k=k, tile_r=tile)
    torch.cuda.synchronize()
    assert rk.launches == n0 + 1
    wv, wp = rk.rerank_stream_topk_plain(base, q, cand, xn, k=k, tile_r=tile)
    if integer:                     # f32 exact: bit for bit
        assert torch.equal(gv, wv) and torch.equal(gp, wp)
        return
    # the reduction order differs: 1e-6 of the terms whose sum is rounded
    tol = 1e-6 * ((q * q).sum(-1, keepdim=True) + xn.max(1, keepdim=True)[0])
    fin = torch.isfinite(wv)
    assert torch.equal(fin, torch.isfinite(gv))
    assert bool((torch.where(fin, (gv - wv).abs(), 0) <= tol).all())
    gap = torch.diff(wv, dim=1).abs() <= tol
    isolated = ~(torch.cat([gap, gap[:, -1:]], 1) | torch.cat([gap[:, :1], gap], 1))
    assert torch.equal(gp[isolated & fin], wp[isolated & fin])


def test_wrappers_raise_on_mixed_devices(dev):
    table, codes, probes, sizes, _ = _k1_inputs(0, dev, g=2, nlist=2, cap=32,
                                                mh=4, fill=None)
    with pytest.raises(ValueError, match="is on"):
        fk.fastscan_stream_topk_grouped(table, codes.cpu(), probes, sizes,
                                        kc=4, tile_n=32)
    base, q, cand, xn = _k2_inputs(0, dev, n=50, d=8, q=2, rp=8,
                                   integer=False)
    with pytest.raises(ValueError, match="is on"):
        rk.rerank_stream_topk(base, q.cpu(), cand, xn, k=4, tile_r=8)


def test_library_builds_once_per_checkout(dev):
    lib = _build.load_library()
    assert _build.load_library() is lib
    assert "sm_90a" in _build.build_log or _build.build_seconds == 0.0


def test_card_engine_equals_host_engine(dev):
    ds = make_sift_like(n=20_000, nt=5_000, nq=32, d=32, ncl=16, seed=4,
                        device=dev)
    card = SearchEngine.build(ds.train, ds.base, m=8, nlist=64,
                              config=EngineConfig(nprobe=8, rerank_mult=4,
                                                  scan_impl="stream",
                                                  rerank_impl="stream"),
                              seed=0, device=dev)
    host = interop.engine_from_arrays(interop.arrays_from_engine(card),
                                      config=card.config, device="cpu")
    lists = card.index.lists
    mask = (torch.rand(lists.ids.shape, device=dev,
                       generator=torch.Generator(device=dev).manual_seed(0)) < 0.5)
    fbits = pack_filter_mask(mask & (lists.ids >= 0))
    for fb in (None, fbits):
        n0 = (fk.launches, rk.launches)
        got = card.search_jit(ds.queries, 10, filter_bits=fb)
        assert fk.launches > n0[0] and rk.launches > n0[1]
        want = host.search_jit(ds.queries.cpu(), 10,
                               filter_bits=None if fb is None else fb.cpu())
        torch.testing.assert_close(got.dists.cpu(), want.dists, rtol=1e-5,
                                   atol=0)
        same = (got.ids.cpu() == want.ids)
        near = torch.isclose(got.dists.cpu(), want.dists, rtol=1e-5)
        assert bool((same | near).all())
        for a, b in zip(got.stats, want.stats):
            assert torch.equal(a.cpu(), b)


# (g, cap or N, mh, tile): odd M/2, M=2, tile 8, the serving shape, and M=128
GROUPED_CASES = [(3, 64, 4, 32), (8, 96, 3, 32), (5, 40, 1, 8),
                 (512, 4096, 8, 1024), (64, 1024, 8, 128), (2, 64, 64, 64)]


@pytest.mark.parametrize("case", range(len(GROUPED_CASES)))
def test_k3_k5_k6_kernels_equal_plain(dev, case):
    g, n, mh, tile = GROUPED_CASES[case]
    rng = np.random.default_rng(100 + case)
    table = torch.as_tensor(rng.integers(0, 256, (g, 2 * mh, 16), np.uint8),
                            device=dev)
    codes = torch.as_tensor(rng.integers(0, 256, (g, n, mh), np.uint8),
                            device=dev)
    want = sk.fastscan_grouped_plain(table, codes, tile_n=tile)
    for mod, fn in ((sk, sk.fastscan_select_tree_grouped),
                    (mk, mk.fastscan_onehot_mxu_grouped)):
        n0 = mod.launches
        got = fn(table, codes, tile_n=tile)
        torch.cuda.synchronize()
        assert mod.launches == n0 + 1
        assert torch.equal(got, want), fn.__name__
    # K3 over a store of nlist = g // 2 + 1 lists, with -1 probes
    nlist = g // 2 + 1
    probes = rng.integers(0, nlist, g).astype(np.int32)
    probes[rng.random(g) < 0.1] = -1
    probes = torch.as_tensor(probes, device=dev)
    store = codes[:nlist].contiguous()
    n0 = sgk.launches
    got = sgk.fastscan_stream_grouped(table, store, probes, tile_n=tile)
    torch.cuda.synchronize()
    assert sgk.launches == n0 + 1
    assert torch.equal(got, sgk.fastscan_stream_grouped_plain(
        table, store, probes, tile_n=tile))


# (q, p, nlist, cap, mh, tile, keep, filter fill, skew)
PRUNE_CASES = [(3, 4, 6, 64, 4, 16, 8, None, True),
               (2, 8, 8, 64, 4, 16, 4, 0.5, True),
               (4, 3, 5, 100, 3, 100, 9, None, False),
               (128, 32, 1024, 4096, 8, 1024, 40, 0.5, True),
               (1, 32, 1024, 4096, 8, 1024, 40, None, True)]


@pytest.mark.parametrize("case", range(len(PRUNE_CASES)))
def test_k4_kernel_equals_plain(dev, case):
    q, p, nlist, cap, mh, tile, keep, fill, skew = PRUNE_CASES[case]
    rng = np.random.default_rng(200 + case)
    g = q * p
    table, codes, probes, sizes, bits = _k1_inputs(
        300 + case, dev, g=g, nlist=nlist, cap=cap, mh=mh, fill=fill,
        invalid=0.05)
    scales = rng.uniform(0.5, 2.0, g).astype(np.float32)
    biases = rng.uniform(0.0, 50.0, g).astype(np.float32)
    if skew:
        biases.reshape(q, p)[:, p // 2:] += np.float32(1e4)
    scales, biases = (torch.as_tensor(a, device=dev) for a in (scales, biases))
    acc_min = torch.sum(torch.amin(table, dim=-1), dim=-1, dtype=torch.int32)
    bounds = scales * acc_min.float() + biases
    n0 = spk.launches
    got = spk.fastscan_stream_topk_prune(
        table, codes, probes, sizes, bounds, scales, biases, kc=keep,
        tile_n=tile, groups_per_query=p, filter_bits=bits)
    torch.cuda.synchronize()
    assert spk.launches == n0 + 1
    want = spk.fastscan_stream_topk_prune_plain(
        table, codes, probes, sizes, bounds, scales, biases, kc=keep,
        tile_n=tile, groups_per_query=p, filter_bits=bits)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    if skew:
        assert int(got[2].sum()) > 0


def test_anytime_card_engine_equals_host_engine(dev):
    ds = make_sift_like(n=20_000, nt=5_000, nq=32, d=32, ncl=16, seed=4,
                        device=dev)
    cfg = EngineConfig(nprobe=16, probe_policy="margin", margin_tau=0.4,
                       early_exit=True, scan_impl="stream", rerank_mult=4,
                       rerank_impl="auto")
    card = SearchEngine.build(ds.train, ds.base, m=8, nlist=64, config=cfg,
                              seed=0, device=dev)
    host = interop.engine_from_arrays(interop.arrays_from_engine(card),
                                      config=cfg._replace(rerank_impl="stream"),
                                      device="cpu")
    n0 = spk.launches
    try:
        for tau in (0.0, 0.4, float("inf")):
            got = card.search_jit(ds.queries, 10, margin_tau=tau)
            want = host.search_jit(ds.queries.cpu(), 10, margin_tau=tau)
            torch.testing.assert_close(got.dists.cpu(), want.dists, rtol=1e-5,
                                       atol=0)
            same = got.ids.cpu() == want.ids
            near = torch.isclose(got.dists.cpu(), want.dists, rtol=1e-5)
            assert bool((same | near).all())
            for a, b in zip(got.stats, want.stats):
                assert torch.equal(a.cpu(), b)
    finally:
        ops.clear_autotune_cache()
    assert spk.launches > n0
    # the gathered impls on the card: K5 and K6 on the engine path
    for impl, mod in (("select", sk), ("mxu", mk)):
        eng = SearchEngine(card.index, base=card.base,
                           base_norms=card.base_norms,
                           config=cfg._replace(scan_impl=impl,
                                               rerank_impl="gathered"))
        n0 = mod.launches
        got = eng.search_jit(ds.queries, 10, margin_tau=0.4)
        want = host.search_jit(ds.queries.cpu(), 10, margin_tau=0.4)
        assert mod.launches > n0
        torch.testing.assert_close(got.dists.cpu(), want.dists, rtol=1e-5,
                                   atol=0)

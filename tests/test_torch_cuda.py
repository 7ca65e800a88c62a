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
from repro_torch.kernels import rerank_kernel as rk

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
                              config=EngineConfig(nprobe=8, rerank_mult=4),
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

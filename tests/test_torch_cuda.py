"""The port's CUDA kernels and engine on the card, held against the port's
own plain PyTorch versions and host pipeline.

Every test here carries the ``cuda`` marker and skips inside the test when
no card is present. The module imports neither jax nor the JAX package, so
it runs on a machine that has only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

(``--noconftest`` because ``tests/conftest.py`` imports jax.)
"""
import functools
import gc
import sys
import threading

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.core import fastscan as fs
from repro_torch.core import pq
from repro_torch.core import ivf as tivf
from repro_torch.core.lists import pack_filter_mask
from repro_torch.core.pq import PQCodebook
from repro_torch.data.vectors import make_sift_like
from repro_torch.engine import EngineConfig, SearchEngine, fused_cache_size
from repro_torch.engine import graphs
from repro_torch.kernels import _build
from repro_torch.kernels import blockmin_kernel as bk
from repro_torch.kernels import fastscan_kernel as fk
from repro_torch.kernels import mxu_flat_kernel as mfk
from repro_torch.kernels import mxu_kernel as mk
from repro_torch.kernels import pq_decode_kernel as pqk
from repro_torch.kernels import ops
from repro_torch.kernels import rerank_kernel as rk
from repro_torch.kernels import select_flat_kernel as sfk
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


# (g, nlist, cap, mh, tile, kc, filter fill, invalid-probe share, LUT): the
# LUT is random u8, {0, 1} (hundreds of rows tie at the kc-th value) or all
# 255 (every row in one histogram bin). Every case with a valid probe also
# probes a list with fewer than kc live rows. The selection's edges: kc ==
# tile_n (16 and 1024), kc > 64, M/2 in {3 (byte loads), 8, 16, 32} and
# M/2 = 5 (the shared-memory row sum), tiles of 100 and 8192 rows.
K1_CASES = [(1, 3, 64, 4, 64, 5, None, 0.0, "rand"),
            (8, 5, 64, 3, 32, 7, 0.5, 0.1, "rand"),     # odd M/2
            (8, 5, 100, 4, 100, 9, 0.5, 0.1, "rand"),   # non-power-of-two
            (64, 16, 4096, 8, 1024, 40, 0.5, 0.05, "rand"),
            (16, 4, 8192, 8, 8192, 40, None, 0.0, "rand"),  # 8192-row tile
            (4, 2, 64, 8, 16, 16, 1.0, 1.0, "rand"),    # every probe invalid
            (8, 6, 2048, 8, 1024, 40, None, 0.0, "01"),
            (8, 6, 2048, 8, 1024, 40, 0.5, 0.05, "01"),
            (6, 4, 1024, 8, 1024, 40, None, 0.0, "255"),
            (6, 4, 2048, 8, 1024, 1024, 0.5, 0.0, "rand"),  # kc == tile_n
            (6, 4, 2048, 8, 1024, 200, None, 0.0, "01"),    # kc > 64
            (6, 4, 1024, 16, 512, 40, 0.5, 0.0, "rand"),
            (6, 4, 1024, 32, 256, 40, None, 0.0, "01"),
            (6, 4, 300, 5, 100, 33, 0.5, 0.0, "rand")]


@pytest.mark.parametrize("case", range(len(K1_CASES)))
def test_k1_kernel_equals_plain(dev, case):
    g, nlist, cap, mh, tile, kc, fill, invalid, lut = K1_CASES[case]
    table, codes, probes, sizes, bits = _k1_inputs(
        case, dev, g=g, nlist=nlist, cap=cap, mh=mh, fill=fill,
        invalid=invalid)
    if lut == "01":
        table = table & 1
    elif lut == "255":
        table.fill_(255)
    if invalid < 1.0:   # list 1 holds fewer than kc rows, and is probed
        sizes[1] = kc // 2
        probes[min(1, g - 1)] = 1
    n0 = fk.launches
    got = fk.fastscan_stream_topk_grouped(table, codes, probes, sizes, kc=kc,
                                          tile_n=tile, filter_bits=bits)
    torch.cuda.synchronize()
    assert fk.launches == n0 + 1
    want = fk.fastscan_stream_topk_plain(table, codes, probes, sizes, kc=kc,
                                         tile_n=tile, filter_bits=bits)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_k1_smem_mirror_equals_the_kernels_export(dev):
    """The Python mirror the CPU wrappers and the autotune sweep reject
    tiles with computes what K1's .cu exports, over the tile grid."""
    lib = _build.load_library()
    fn = lib.repro_fastscan_stream_topk_smem
    for tile in (1, 8, 16, 31, 64, 100, 256, 1000, 1024, 2048, 4096, 8192,
                 16384, 20000, 32768, 65536):
        for kc in {1, 4, 32, 33, 40, 64, 65, 200, tile // 2 or 1, tile}:
            if kc > tile:
                continue
            for m in (2, 6, 16, 32, 64, 128, 1024, 6336, 14518):
                assert fn(tile, kc, m) == fk.smem_bytes(tile, kc, m), (
                    tile, kc, m)


def _k2_inputs(seed, dev, *, n, d, q, rp, integer, edge=None):
    rng = np.random.default_rng(seed)
    if integer:
        base = rng.integers(-4, 5, (n, d)).astype(np.float32)
        qv = rng.integers(-4, 5, (q, d)).astype(np.float32)
        base[1] = base[0]
    else:
        base = rng.normal(size=(n, d)).astype(np.float32)
        qv = rng.normal(size=(q, d)).astype(np.float32)
    cand = rng.integers(0, n, (q, rp)).astype(np.int32)
    if edge == "ties":      # ids 0..3 repeated: ties at the k cut
        cand = rng.integers(0, 4, (q, rp)).astype(np.int32)
    cand[rng.random((q, rp)) < 0.2] = -1
    cand[0, :3] = [0, 1, 0]
    if q > 1:
        cand[1] = -1
    if edge == "pad_chunk":  # the second chunk of 16 holds only -1
        cand[:, 16:32] = -1
    base_t, q_t, cand_t = (torch.as_tensor(a, device=dev)
                           for a in (base, qv, cand))
    if edge == "unaligned":  # a contiguous view 4 bytes past 16-byte
        flat = torch.empty(n * d + 1, device=dev)
        flat[1:] = base_t.reshape(-1)
        base_t = flat[1:].view(n, d)
        assert base_t.data_ptr() % 16 == 4
    xn = (base_t * base_t).sum(-1)[cand_t.clamp_min(0).long()].contiguous()
    return base_t, q_t, cand_t, xn


# (D, Rp, tile_r, k, Q, edge): the first three are the first version's
# cases; then Q = 1, several chunks (tile 16 at Rp = 48), ties at the k cut
# from repeated ids, a chunk of only -1, k > tile_r, k >= 64, D = 960 (a
# GIST width, eight 128-column slices) and a base view that is not 16-byte
# aligned (the scalar column path)
K2_CASES = [(128, 64, 64, 10, 6, None), (128, 128, 32, 10, 6, None),
            (30, 16, 8, 20, 6, None), (128, 64, 64, 10, 1, None),
            (128, 48, 16, 10, 6, None), (128, 64, 16, 10, 6, "ties"),
            (128, 64, 16, 10, 5, "pad_chunk"), (64, 32, 8, 20, 4, None),
            (128, 128, 64, 70, 3, None), (960, 64, 32, 10, 3, None),
            (128, 64, 32, 10, 4, "unaligned")]


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("case", range(len(K2_CASES)))
def test_k2_kernel_matches_plain(dev, integer, case):
    d, rp, tile, k, q, edge = K2_CASES[case]
    base, q, cand, xn = _k2_inputs(d + rp, dev, n=500, d=d, q=q, rp=rp,
                                   integer=integer, edge=edge)
    n0 = rk.launches
    gv, gp = rk.rerank_stream_topk(base, q, cand, xn, k=k, tile_r=tile)
    torch.cuda.synchronize()
    assert rk.launches == n0 + 1
    wv, wp = rk.rerank_stream_topk_plain(base, q, cand, xn, k=k, tile_r=tile)
    fin_k = torch.isfinite(wv[:, -1])
    if edge == "ties" and integer:  # the k-th value straddles the cut
        assert bool(((wv[:, -1] == wv[:, -2]) & fin_k).any())
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


def test_k2_smem_mirror_equals_the_kernels_export(dev):
    """K2's Python mirror (the CPU wrapper's check) computes what its .cu
    exports, over the card-test shapes and a (D, tile_r, k) grid."""
    fn = _build.load_library().repro_rerank_stream_topk_smem
    shapes = {(d, tile, k) for d, _, tile, k, _, _ in K2_CASES}
    for d in (1, 30, 128, 960, 50000):
        for tile in (1, 8, 16, 32, 64, 100, 1024, 14600):
            for k in (1, 10, 64, 70, 1000, 14000):
                shapes.add((d, tile, k))
    for d, tile, k in sorted(shapes):
        assert fn(d, tile, k) == rk.smem_bytes(d, tile, k), (d, tile, k)


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


# (g, cap or N, mh, tile, LUT, zero-group share): odd M/2, M=2, tile 8,
# the serving shape, M=128 (K6 reads B from shared memory; K5 takes its
# any-M path), an all-255 LUT (every sum M * 255), and gathered copies
# whose -1-probe groups are zero rows; N = 40 and 96 leave a chunk part
# full and rows unaligned. Then K5's edges: G = 32 at N = 4096 (units
# shrink), N = 1030 (a part-full unit, N % 4 = 2: scalar stores, rows not
# 16-byte aligned), all-255 LUTs at M = 16 and 32 on the four-row path,
# and M/2 = 2, 6 and 12 (8- and 16-byte stage loads)
GROUPED_CASES = [(3, 64, 4, 32, "rand", 0.0), (8, 96, 3, 32, "rand", 0.0),
                 (5, 40, 1, 8, "rand", 0.0), (512, 4096, 8, 1024, "rand", 0.0),
                 (64, 1024, 8, 128, "rand", 0.0), (2, 64, 64, 64, "rand", 0.0),
                 (4, 64, 64, 8, "255", 0.0), (6, 96, 64, 32, "255", 0.3),
                 (64, 4096, 8, 1024, "rand", 0.3),
                 (7, 40, 3, 8, "rand", 0.3),
                 (32, 4096, 8, 1024, "rand", 0.05),
                 (3, 1030, 8, 10, "rand", 0.0),
                 (16, 2048, 8, 1024, "255", 0.0),
                 (4, 512, 16, 128, "255", 0.0),
                 (5, 520, 2, 8, "rand", 0.0), (6, 520, 6, 8, "rand", 0.0),
                 (6, 520, 12, 8, "rand", 0.2)]


@pytest.mark.parametrize("case", range(len(GROUPED_CASES)))
def test_k3_k5_k6_kernels_equal_plain(dev, case):
    g, n, mh, tile, lut, zero = GROUPED_CASES[case]
    rng = np.random.default_rng(100 + case)
    table = rng.integers(0, 256, (g, 2 * mh, 16), np.uint8)
    if lut == "255":
        table[:] = 255
    codes = rng.integers(0, 256, (g, n, mh), np.uint8)
    if zero:
        codes[rng.random(g) < zero] = 0
    table = torch.as_tensor(table, device=dev)
    codes = torch.as_tensor(codes, device=dev)
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


# (g, nlist, cap, mh, tile, LUT, -1 probe share, byte offset of the
# store): every M/2 of the four-row set, with one, two and four quads a
# thread (units shrink below 264 units) and part-full units; M/2 = 5 and
# 64 off the set; list bases 16-, 8-, 4- and 1-byte aligned (cap x M/2 =
# 96 x 3, 40 x 1, 1002 x 2, 37 x 3, 999 x 8, and a store starting 3 bytes
# into its buffer); odd caps read as one tile (output rows not 16-byte
# aligned, a part-full last quad); all probes -1, G = 1, nlist = 1, one
# query's probes (G = 32) over cap 4096, and an all-255 LUT at M = 32 (the
# largest sum the 16-bit lanes hold, 8,160)
K3_CASES = [(300, 40, 4096, 1, 1024, "rand", 0.1, 0),
            (150, 40, 4096, 2, 512, "rand", 0.1, 0),
            (64, 30, 1024, 3, 256, "rand", 0.1, 0),
            (300, 40, 2048, 4, 2048, "rand", 0.1, 0),
            (100, 40, 3000, 6, 1000, "rand", 0.1, 0),
            (600, 64, 4096, 8, 1024, "rand", 0.05, 0),
            (40, 20, 520, 12, 8, "rand", 0.1, 0),
            (300, 30, 4100, 16, 4100, "rand", 0.1, 0),
            (20, 10, 1500, 5, 500, "rand", 0.1, 0),
            (6, 4, 2100, 64, 700, "rand", 0.2, 0),
            (8, 5, 96, 3, 32, "rand", 0.1, 0),
            (5, 4, 40, 1, 8, "rand", 0.1, 0),
            (10, 6, 1002, 2, 501, "rand", 0.1, 0),
            (7, 5, 37, 3, 37, "rand", 0.1, 0),
            (9, 6, 999, 8, 999, "rand", 0.1, 0),
            (12, 6, 512, 8, 128, "rand", 0.1, 3),
            (16, 4, 1024, 8, 1024, "rand", 1.0, 0),
            (1, 3, 4096, 8, 1024, "rand", 0.0, 0),
            (10, 1, 512, 8, 64, "rand", 0.1, 0),
            (32, 64, 4096, 8, 1024, "rand", 0.05, 0),
            (64, 8, 2048, 16, 256, "255", 0.1, 0)]


@pytest.mark.parametrize("case", range(len(K3_CASES)))
def test_k3_kernel_equals_plain(dev, case):
    g, nlist, cap, mh, tile, lut, invalid, off = K3_CASES[case]
    rng = np.random.default_rng(700 + case)
    table = rng.integers(0, 256, (g, 2 * mh, 16), np.uint8)
    if lut == "255":
        table[:] = 255
    flat = rng.integers(0, 256, off + nlist * cap * mh, np.uint8)
    probes = rng.integers(0, nlist, g).astype(np.int32)
    probes[rng.random(g) < invalid] = -1
    table = torch.as_tensor(table, device=dev)
    store = torch.as_tensor(flat, device=dev)[off:].view(nlist, cap, mh)
    assert store.data_ptr() % 16 == off
    probes = torch.as_tensor(probes, device=dev)
    n0 = sgk.launches
    got = sgk.fastscan_stream_grouped(table, store, probes, tile_n=tile)
    torch.cuda.synchronize()
    assert sgk.launches == n0 + 1
    want = sgk.fastscan_stream_grouped_plain(table, store, probes,
                                             tile_n=tile)
    assert torch.equal(got, want)
    assert not got[probes < 0].any()
    if lut == "255":
        assert int(got[probes >= 0].min()) == 8160


def test_k3_smem_mirror_equals_the_kernels_export(dev):
    """K3's Python mirror (the CPU wrapper's check) equals the .cu's over
    every even M up to 15,000 (the four-row ring up to M = 32, the LUT
    alone beyond; the plan does not depend on the tile)."""
    fn = _build.load_library().repro_fastscan_stream_grouped_smem
    for m in range(2, 15001, 2):
        assert fn(m) == sgk.smem_bytes(m), m
    for case in K3_CASES:
        assert case[2] % case[4] == 0 and fn(2 * case[3]) <= _build.SMEM_LIMIT


def test_k6_smem_mirror_equals_the_kernels_export(dev):
    """K6's Python plan (the CPU wrapper's check) equals the .cu's over the
    card-test widths and tiles and every even M up to 1100 (the plan does
    not depend on the tile)."""
    fn = _build.load_library().repro_fastscan_onehot_mma_grouped_smem
    widths = {2 * case[2] for case in GROUPED_CASES} | set(range(2, 1101, 2))
    for m in sorted(widths):
        assert fn(m) == mk.smem_bytes(m), m
    for g, n, mh, tile, _, _ in GROUPED_CASES:
        assert n % tile == 0 and fn(2 * mh) <= _build.SMEM_LIMIT


def test_k5_smem_mirror_equals_the_kernels_export(dev):
    """K5's Python mirror (the CPU wrapper's check) equals the .cu's over
    every even M up to 15,000 (the four-row ring up to M = 32, the LUT
    alone beyond; the plan does not depend on the tile)."""
    fn = _build.load_library().repro_fastscan_select_grouped_smem
    for m in range(2, 15001, 2):
        assert fn(m) == sk.smem_bytes(m), m
    for g, n, mh, tile, _, _ in GROUPED_CASES:
        assert n % tile == 0 and fn(2 * mh) <= _build.SMEM_LIMIT


# (q, p, nlist, cap, mh, tile, keep, filter fill, skew, LUT): the LUT is
# random u8, {0, 1} (hundreds of rows tie at the kc-th value) or all 255
# (every row in the top histogram bin). Every case probes a list with no
# row and one with fewer than kc live rows. The selection's edges: kc ==
# tile_n and kc = 200 (above 64: the block-wide sort and merge), M/2 in
# {4, 8, 16} (one radix pass) and 32 (two), a 16384-row tile (one LUT
# stage, codes read in place) and M = 14518 (no stage: the LUT read in
# place).
PRUNE_CASES = [(3, 4, 6, 64, 4, 16, 8, None, True, "rand"),
               (2, 8, 8, 64, 4, 16, 4, 0.5, True, "rand"),
               (4, 3, 5, 100, 3, 100, 9, None, False, "rand"),
               (128, 32, 1024, 4096, 8, 1024, 40, 0.5, True, "rand"),
               (1, 32, 1024, 4096, 8, 1024, 40, None, True, "rand"),
               (3, 8, 6, 1024, 8, 1024, 40, None, True, "01"),
               (2, 8, 6, 2048, 8, 1024, 40, 0.5, False, "01"),
               (3, 4, 6, 1024, 8, 1024, 40, None, True, "255"),
               (2, 4, 4, 256, 4, 256, 256, None, False, "rand"),
               (2, 4, 4, 2048, 8, 1024, 200, 0.5, True, "rand"),
               (2, 4, 4, 2048, 8, 1024, 200, None, False, "01"),
               (2, 6, 6, 512, 16, 256, 40, None, False, "rand"),
               (2, 8, 6, 256, 32, 256, 40, None, True, "rand"),
               (2, 4, 4, 1024, 4, 1024, 64, None, False, "rand"),
               (1, 2, 2, 16384, 8, 16384, 40, None, False, "rand"),
               (1, 2, 2, 16, 7259, 8, 4, None, False, "rand")]


@pytest.mark.parametrize("case", range(len(PRUNE_CASES)))
def test_k4_kernel_equals_plain(dev, case):
    q, p, nlist, cap, mh, tile, keep, fill, skew, lut = PRUNE_CASES[case]
    rng = np.random.default_rng(200 + case)
    g = q * p
    table, codes, probes, sizes, bits = _k1_inputs(
        300 + case, dev, g=g, nlist=nlist, cap=cap, mh=mh, fill=fill,
        invalid=0.05)
    if lut == "01":
        table = table & 1
    elif lut == "255":
        table.fill_(255)
    # list 0 holds no row, list 1 fewer than kc live rows; both are probed
    sizes[0], sizes[1] = 0, keep // 2
    probes[0], probes[min(1, g - 1)] = 0, 1
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


def test_k4_smem_mirror_equals_the_kernels_export(dev):
    """The Python mirror the CPU wrappers and the autotune sweep reject
    tiles with computes what the .cu exports, over the tile grid."""
    lib = _build.load_library()
    fn = lib.repro_fastscan_stream_topk_prune_smem
    for tile in (1, 8, 16, 31, 64, 100, 256, 1000, 1024, 2048, 4096, 8192,
                 16384):
        for kc in {1, 4, 32, 33, 40, 64, 65, 200, tile // 2 or 1, tile}:
            if kc > tile:
                continue
            for m in (2, 6, 16, 32, 64, 128, 1024, 14518):
                assert fn(tile, kc, m) == spk.smem_bytes(tile, kc, m), (
                    tile, kc, m)


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


# (q, n, mh, lut values): every register-LUT M/2 and the shared-memory one
# (M/2 = 5, 32, 64), Q and N off the CTA tiles (N = 1, 3, 4097: no
# multiple of 4), a {0, 1} LUT (ties), an all-255 LUT at M = 32 (8,160 in
# each 16-bit lane), the serving width at a million rows. K7b's edges:
# each (query tiles, row blocks) pair with Q and N one either side of its
# query block and chunk -- (1, 8): Q <= 8, 1024-row chunks; (2, 4): Q <=
# 16, 512 rows; (4, 2): Q <= 32, 256 rows; (8, 1): 64 queries, 128 rows --
# M = 302 (its buffers shrink the pair to (2, 1)), and Q = 128 at N =
# 1,000,000.
FLAT_CASES = [(1, 33, 1, 256), (3, 100, 2, 256), (17, 1500, 3, 256),
              (16, 1024, 4, 256), (5, 2047, 5, 2), (33, 3000, 6, 256),
              (8, 4096, 8, 2), (20, 999, 12, 256), (32, 5000, 16, 256),
              (2, 700, 64, 256), (128, 1_000_448, 8, 256),
              (2, 1, 4, 256), (3, 3, 8, 256), (17, 4097, 8, 256),
              (5, 4097, 1, 256), (4, 1001, 32, 256), (19, 4097, 16, 255),
              (3, 4097, 6, 255), (7, 1023, 8, 256), (8, 1025, 4, 2),
              (9, 511, 8, 256), (16, 513, 8, 256), (17, 255, 8, 256),
              (32, 257, 8, 256), (33, 127, 8, 256), (63, 129, 8, 256),
              (65, 255, 8, 256), (9, 1000, 151, 256),
              (128, 1_000_000, 8, 256)]


def _flat_inputs(seed, dev, q, n, mh, levels):
    """levels 255: every LUT entry 255; else entries in [0, levels)."""
    rng = np.random.default_rng(seed)
    table = rng.integers(0, levels, (q, 2 * mh, 16), np.uint8)
    if levels == 255:
        table[:] = 255
    codes = rng.integers(0, 256, (n, mh), np.uint8)
    return (torch.as_tensor(table, device=dev),
            torch.as_tensor(codes, device=dev))


@pytest.mark.parametrize("case", range(len(FLAT_CASES)))
def test_k7a_k7b_kernels_equal_plain(dev, case):
    q, n, mh, levels = FLAT_CASES[case]
    table, codes = _flat_inputs(400 + case, dev, q, n, mh, levels)
    want = sfk.fastscan_distances_plain(table, codes)
    for mod, fn in ((sfk, sfk.fastscan_select_tree),
                    (mfk, mfk.fastscan_onehot_mxu)):
        n0 = mod.launches
        got = fn(table, codes)
        torch.cuda.synchronize()
        assert mod.launches == n0 + 1
        assert torch.equal(got, want), fn.__name__


def test_k7_extreme_values_stay_exact(dev):
    table = torch.full((3, 128, 16), 255, dtype=torch.uint8, device=dev)
    codes = torch.randint(0, 256, (300, 64), dtype=torch.uint8, device=dev,
                          generator=torch.Generator(device=dev).manual_seed(0))
    for fn in (sfk.fastscan_select_tree, mfk.fastscan_onehot_mxu):
        got = fn(table, codes)
        assert int(got.min()) == int(got.max()) == 255 * 128
    mins, ids = bk.fastscan_blockmin(table, codes, tile_n=100)
    assert bool((mins == 255 * 128).all())
    assert torch.equal(ids, torch.arange(0, 300, 100, dtype=torch.int32,
                                         device=dev).expand(3, 3))


# (q, n, mh, block, lut values; 255: every entry 255): levels 2 ties sums
# across lanes, warps, chunks and CTAs; blocks of 3 (many a chunk) and 2500
# (straddling chunks of 256 to 1024 rows); Q in {1, 9, 65, 128} (one query
# tile, a partial query tile, a query block of one query); the kernel's
# 32-bit keys at their edge (M = 256, all sums 65,280) and its (sum, row)
# pairs past it (M = 260, sums of 66,300; a block of 131,072 rows)
BLOCKMIN_CASES = [(1, 64, 4, 64, 256), (3, 1500, 2, 100, 2),
                  (17, 2048, 8, 1024, 2), (20, 3000, 3, 1000, 256),
                  (8, 5000, 16, 2500, 256), (2, 90, 5, 3, 2),
                  (128, 1_000_448, 8, 1024, 256),
                  (1, 100_000, 8, 2500, 2), (9, 30_000, 8, 3, 2),
                  (65, 200_000, 8, 2500, 2), (128, 262_144, 8, 1024, 2),
                  (65, 3000, 5, 3, 2), (128, 50_000, 16, 2500, 2),
                  (2, 3000, 128, 1000, 255), (3, 5000, 130, 1000, 255),
                  (3, 5000, 130, 1000, 2), (2, 262_144, 4, 131_072, 2)]


@pytest.mark.parametrize("case", range(len(BLOCKMIN_CASES)))
def test_k7c_kernel_equals_plain(dev, case):
    q, n, mh, block, levels = BLOCKMIN_CASES[case]
    table, codes = _flat_inputs(500 + case, dev, q, n, mh, levels)
    n0 = bk.launches
    got = bk.fastscan_blockmin(table, codes, tile_n=block)
    torch.cuda.synchronize()
    assert bk.launches == n0 + 1
    want = bk.fastscan_blockmin_plain(table, codes, tile_n=block)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_ops_blockmin_pads_and_a_padded_row_can_win(dev):
    """block 100 on N=1500 (no N % 8 rule), and N=1450: the 0xFF-padded
    rows sum to 0 here, so they win the last block with ids >= N."""
    rng = np.random.default_rng(7)
    table = rng.integers(1, 256, (5, 8, 16), np.uint8)
    table[:, :, 15] = 0
    codes = rng.integers(0, 15, (1500, 4), np.uint8)
    codes |= rng.integers(0, 15, (1500, 4), np.uint8) << 4   # no nibble 15
    t, c = (torch.as_tensor(a, device=dev) for a in (table, codes))
    for n in (1500, 1450):
        mins, ids = ops.fastscan_blockmin(t, c[:n], block=100)
        assert mins.shape == ids.shape == (5, 15)
        padded = ops._pad_to(c[:n], 0, 100, value=0xFF)
        wm, wi = bk.fastscan_blockmin_plain(t, padded, tile_n=100)
        assert torch.equal(mins, wm) and torch.equal(ids, wi)
        assert bool((ids[:, -1] >= n).all()) == (n == 1450)


def test_k7_wrappers_check_shared_memory_before_launch(dev):
    m = 4096
    table = torch.zeros((1, m, 16), dtype=torch.uint8, device=dev)
    codes = torch.zeros((8, m // 2), dtype=torch.uint8, device=dev)
    n0 = (sfk.launches, mfk.launches, bk.launches, mk.launches)
    with pytest.raises(ValueError, match="shared memory"):
        mk.fastscan_onehot_mxu_grouped(table, codes[None], tile_n=8)
    with pytest.raises(ValueError, match="shared memory"):
        sfk.fastscan_select_tree(table, codes)
    with pytest.raises(ValueError, match="shared memory"):
        mfk.fastscan_onehot_mxu(table, codes)
    with pytest.raises(ValueError, match="shared memory"):
        bk.fastscan_blockmin(table, codes, tile_n=8)
    assert (sfk.launches, mfk.launches, bk.launches, mk.launches) == n0
    lib = _build.load_library()
    # M; K8's scoring pass's (g, M); (tile_n, kc, M) or (D, tile_r, k);
    # K8's (g, M, head_dim, q8)
    shapes = {1: (16,), 2: (2, 64), 3: (1024, 40, 16), 4: (2, 64, 128, 1)}
    for fn, nargs in _build.SMEM_FNS.items():
        assert 0 < getattr(lib, fn)(*shapes[nargs]) <= _build.SMEM_LIMIT


def test_flat_search_card_equals_host(dev):
    ds = make_sift_like(n=20_000, nt=5_000, nq=32, d=32, ncl=16, seed=4,
                        device=dev)
    card = fs.build_index(ds.train, ds.base, m=8, seed=0, device=dev)
    host = interop.fastscan_index_from_arrays(
        interop.arrays_from_fastscan_index(card), device="cpu")
    q = ds.queries
    for metric in ("l2", "ip"):
        # the u8 tables of both sides, so that an entry rounded the other
        # way (the f32 LUTs differ in the last bits) widens the tolerance
        tc = fs.quantize_lut(pq.adc_table(card.codebook, q, metric=metric))
        th = fs.quantize_lut(pq.adc_table(host.codebook, q.cpu(),
                                          metric=metric))
        flips = (tc.table_q8.cpu() != th.table_q8).sum(dim=(1, 2))
        want = fs.compute_distances(host, q.cpu(), impl="mxu", metric=metric)
        tol = (1e-5 * want.abs().amax(dim=1) + flips * th.scale)[:, None]
        for impl, mod in (("select", sfk), ("mxu", mfk)):
            n0 = mod.launches
            got = fs.compute_distances(card, q, impl=impl, metric=metric)
            assert mod.launches == n0 + 1
            assert bool(((got.cpu() - want).abs() <= tol).all())
        gv, gi = fs.search(card, q, topk=10, impl="mxu", metric=metric)
        wv, wi = fs.search(host, q.cpu(), topk=10, impl="mxu", metric=metric)
        assert bool(((gv.cpu() - wv).abs() <= tol).all())
        same = gi.cpu() == wi
        assert bool((same | ((gv.cpu() - wv).abs() <= tol)).all())
    # the naive-PQ baseline on the card against the host
    codes = fs.unpack_codes(card.packed_codes)
    gv, gi = pq.search(card.codebook, codes, q, topk=10)
    wv, wi = pq.search(host.codebook, codes.cpu(), q.cpu(), topk=10)
    tol = 1e-5 * wv.abs().amax(dim=1, keepdim=True)
    close = (gv.cpu() - wv).abs() <= tol
    assert bool(close.all()) and bool(((gi.cpu() == wi) | close).all())


# ---------------------------------------------------------------------------
# search_jit: one captured CUDA graph per key, held bit for bit against the
# eager search
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _graph_setup():
    """A 20k x 32 index over 64 lists with a 4-tenant namespace table (each
    tenant a random quarter of the lists), queries, a ~50% filter, tenants
    with a quarter of the queries unrestricted, per-query tau."""
    dev = torch.device("cuda")
    ds = make_sift_like(n=20_000, nt=5_000, nq=32, d=32, ncl=16, seed=4,
                        device=dev)
    eng = SearchEngine.build(ds.train, ds.base, m=8, nlist=64,
                             config=EngineConfig(nprobe=8), seed=0,
                             device=dev)
    rng = np.random.default_rng(8)
    member = np.zeros((4, 64), bool)
    for t, part in enumerate(np.split(rng.permutation(64), 4)):
        member[t, part] = True
    lists = eng.index.lists

    def request(seed):
        r = np.random.default_rng(seed)
        mask = torch.as_tensor(r.random(tuple(lists.ids.shape)) < 0.5,
                               device=dev) & (lists.ids >= 0)
        ns = r.integers(0, 4, 32).astype(np.int32)
        ns[r.permutation(32)[:8]] = -1
        return {"filter_bits": pack_filter_mask(mask),
                "namespaces": torch.as_tensor(ns, device=dev),
                "margin_tau": torch.as_tensor(r.uniform(0.1, 0.6, 32),
                                              dtype=torch.float32,
                                              device=dev)}
    return ds, eng, member, request


def _graph_engine(cfg, namespaces=True):
    _, eng, member, _ = _graph_setup()
    return SearchEngine(eng.index, base=eng.base, base_norms=eng.base_norms,
                        config=cfg, namespaces=member if namespaces else None)


def _assert_bitwise(a, b, what=""):
    assert torch.equal(a.dists, b.dists), what
    assert torch.equal(a.ids, b.ids), what
    for f in a.stats._fields:
        assert torch.equal(getattr(a.stats, f), getattr(b.stats, f)), (what, f)


def _owned(eng, res, ns):
    """Every id a namespaced query returned lies in a list its tenant
    owns."""
    lists = eng.index.lists
    owner = torch.full((eng.base.shape[0],), -1, dtype=torch.long,
                       device=lists.ids.device)
    li = torch.arange(lists.nlist, device=owner.device)[:, None].expand(
        lists.ids.shape)
    ok = lists.ids >= 0
    owner[lists.ids[ok].long()] = li[ok]
    for qi, t in enumerate(ns.tolist()):
        got = res.ids[qi][res.ids[qi] >= 0].long()
        if t >= 0 and got.numel():
            assert bool(eng.ns_member[t][owner[got]].all()), qi


# (scan_impl, rerank_impl, probe_policy, early_exit)
GRAPH_CASES = [("stream", "stream", "fixed", False),
               ("stream", "stream", "margin", True),
               ("select", "gathered", "margin", True),
               ("mxu", "gathered", "fixed", False),
               ("auto", "auto", "margin", True),
               ("auto", "auto", "fixed", False)]


@pytest.mark.parametrize("case", range(len(GRAPH_CASES)))
def test_search_jit_graph_equals_eager_search(dev, case):
    scan, rerank, policy, ee = GRAPH_CASES[case]
    cfg = EngineConfig(nprobe=8, rerank_mult=4, scan_impl=scan,
                       rerank_impl=rerank, probe_policy=policy,
                       margin_tau=0.4, early_exit=ee)
    ds, _, _, request = _graph_setup()
    eng = _graph_engine(cfg)
    try:
        for qq in (1, 8, 32):
            q = ds.queries[:qq]
            _assert_bitwise(eng.search_jit(q, 10), eng.search(q, 10), qq)
        q = ds.queries
        names = ["filter_bits", "namespaces"]
        if policy == "margin":
            names.append("margin_tau")
        # each optional input alone and all together, two values each:
        # the second replay of a key must see the new values
        for use in [[n] for n in names] + [names]:
            for seed in (1, 2):
                kw = {n: request(seed)[n] for n in use}
                got = eng.search_jit(q, 10, **kw)
                _assert_bitwise(got, eng.search(q, 10, **kw), (use, seed))
                if "namespaces" in kw:
                    _owned(eng, got, kw["namespaces"])
    finally:
        ops.clear_autotune_cache()
    assert len(eng.graphs) == 3 + len(names) + 1


def test_search_jit_replays_new_values_and_keeps_earlier_results(dev):
    ds, _, _, request = _graph_setup()
    cfg = EngineConfig(nprobe=8, rerank_mult=4, scan_impl="stream",
                       rerank_impl="stream", probe_policy="margin",
                       margin_tau=0.4, early_exit=True)
    eng = _graph_engine(cfg)
    q = ds.queries
    first = eng.search_jit(q, 10, **request(1))
    kept = tuple(t.clone() for t in (first.dists, first.ids, *first.stats))
    n0 = ops.autotune_cache_size(), len(eng.graphs)
    for seed in (2, 3, 4):
        kw = request(seed)
        qs = q.flip(0)
        got = eng.search_jit(qs, 10, **kw)
        _assert_bitwise(got, eng.search(qs, 10, **kw), seed)
        assert not torch.equal(got.ids, first.ids)
    # the caller's earlier result did not move under the later replays
    for a, b in zip((first.dists, first.ids, *first.stats), kept):
        assert torch.equal(a, b)
    assert (ops.autotune_cache_size(), len(eng.graphs)) == n0


def test_fused_cache_size_counts_one_graph_a_key(dev):
    ds, _, _, request = _graph_setup()
    cfg = EngineConfig(nprobe=8, rerank_mult=4, scan_impl="stream",
                       rerank_impl="stream", probe_policy="margin",
                       margin_tau=0.4, early_exit=True)
    eng = _graph_engine(cfg)
    gc.collect()
    n0 = fused_cache_size()
    for _ in range(3):                      # steady traffic over 2 buckets
        for qq in (1, 8):
            eng.search_jit(ds.queries[:qq], 10)
    assert fused_cache_size() == n0 + 2
    for seed in (1, 2, 3):                  # new values at one key each
        kw = request(seed)
        eng.search_jit(ds.queries, 10, filter_bits=kw["filter_bits"])
        eng.search_jit(ds.queries, 10, namespaces=kw["namespaces"])
        eng.search_jit(ds.queries, 10, margin_tau=kw["margin_tau"])
    assert fused_cache_size() == n0 + 5
    eng.search_jit(ds.queries, 5)           # another k
    eng.search_jit(ds.queries, 10, margin_tau=0.3)   # a scalar tau
    assert fused_cache_size() == n0 + 7 == n0 + len(eng.graphs)
    other = _graph_engine(cfg)
    other.search_jit(ds.queries[:1], 10)
    assert fused_cache_size() == n0 + 8
    del eng, other
    gc.collect()
    assert fused_cache_size() == n0


def test_capture_with_an_unresolved_verdict_raises(dev):
    ds, _, _, _ = _graph_setup()
    cfg = EngineConfig(nprobe=8, scan_impl="auto", rerank_impl="stream")
    eng = _graph_engine(cfg, namespaces=False)
    fn, state = eng._bind(k=10, nprobe=8, r=0)

    def forgetful(*args):
        ops.clear_autotune_cache()      # the warm-up's verdicts are lost
        return fn(*args)
    cache = graphs.GraphCache(eng.device)
    q = ds.queries.contiguous()
    key = graphs.graph_key(q, (None, None, None), knobs=(),
                           state=graphs.state_identity(state))
    try:
        with pytest.raises(RuntimeError, match="not resolved before CUDA "
                                               "graph capture"):
            cache.run(key, state, forgetful, (q, None, None, None))
        assert len(cache) == 0
        assert ops.autotune_cache_size() == 0   # no sweep ran in the capture
    finally:
        ops.clear_autotune_cache()
    # the stream still serves: a clean capture goes through
    got = cache.run(key, state, fn, (q, None, None, None))
    _assert_bitwise(got, eng.search(q, 10))
    ops.clear_autotune_cache()


def test_replacing_engine_state_drops_its_graphs(dev):
    ds, _, member, _ = _graph_setup()
    cfg = EngineConfig(nprobe=8, rerank_mult=4, scan_impl="stream",
                       rerank_impl="stream")
    eng = _graph_engine(cfg)
    q = ds.queries
    ns = torch.zeros(32, dtype=torch.int32, device=dev)
    eng.search_jit(q, 10)
    eng.search_jit(q[:8], 10)
    assert len(eng.graphs) == 2
    old = eng.search_jit(q, 10, namespaces=ns)
    # a new table where tenant 0 owns what tenant 1 did
    eng.ns_member = torch.as_tensor(member[[1, 0, 2, 3]], device=dev)
    got = eng.search_jit(q, 10, namespaces=ns)
    assert len(eng.graphs) == 1
    _assert_bitwise(got, eng.search(q, 10, namespaces=ns))
    assert not torch.equal(got.ids, old.ids)
    eng.base = eng.base.clone()
    eng.base_norms = eng.base_norms.clone()
    lists = eng.index.lists
    eng.index = eng.index._replace(lists=lists._replace(
        codes=lists.codes.clone(), ids=lists.ids.clone()))
    for qq in (32, 8):
        _assert_bitwise(eng.search_jit(q[:qq], 10), eng.search(q[:qq], 10))
    assert len(eng.graphs) == 2


def test_launch_counters_grow_with_replays(dev):
    ds, _, _, _ = _graph_setup()
    cfg = EngineConfig(nprobe=8, rerank_mult=4, scan_impl="stream",
                       rerank_impl="stream", probe_policy="margin",
                       margin_tau=0.4, early_exit=True)
    eng = _graph_engine(cfg)
    q = ds.queries
    eng.search_jit(q, 10)                  # warm-up, capture, replay
    counts = []
    for _ in range(3):
        counts.append((spk.launches, rk.launches))
        eng.search_jit(q, 10)
    counts.append((spk.launches, rk.launches))
    steps = {(b[0] - a[0], b[1] - a[1]) for a, b in zip(counts, counts[1:])}
    assert steps == {(1, 1)}


def test_search_jit_from_many_threads_serves_each_request_its_own(dev):
    """Twelve threads on their own streams replay one key with six
    different requests; each result must equal its eager twin (a copy-in
    or clone racing another thread's replay would break it)."""
    ds, _, _, request = _graph_setup()
    cfg = EngineConfig(nprobe=8, rerank_mult=4, scan_impl="stream",
                       rerank_impl="stream", probe_policy="margin",
                       margin_tau=0.4, early_exit=True)
    eng = _graph_engine(cfg)
    q = ds.queries
    reqs = [request(seed) for seed in range(10, 16)]
    want = [eng.search(q, 10, **kw) for kw in reqs]
    eng.search_jit(q, 10, **reqs[0])
    torch.cuda.synchronize()            # the workers read want on theirs
    bad, done = [], []

    def worker(i):
        with torch.cuda.stream(torch.cuda.Stream()):
            for j in range(20):
                r = (i + j) % len(reqs)
                got = eng.search_jit(q, 10, **reqs[r])
                try:
                    _assert_bitwise(got, want[r])
                except AssertionError:
                    bad.append((i, j))
        done.append(i)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert len(done) == 12 and not bad, bad
    assert len(eng.graphs) == 1


# ---------------------------------------------------------------------------
# live mutation on the card
# ---------------------------------------------------------------------------

def _mutable_engine(cfg):
    """An engine over the graph setup's index and base, cap doubled to a
    power of two (spare slots, full-size scan tiles) by its first write,
    which clones what it mutates."""
    ds, eng, _, _ = _graph_setup()
    mut = SearchEngine(eng.index, base=eng.base, base_norms=eng.base_norms,
                       config=cfg)
    mut.compact(cap=1 << (2 * eng.index.lists.cap - 1).bit_length())
    return ds, mut


def _sift_rows(n, seed):
    """New rows from the dataset's generator, rounded to integers as SIFT
    descriptors are (a row's distance to itself is then exactly 0)."""
    return np.rint(make_sift_like(n=max(n, 16), nt=1, nq=1, d=32, ncl=16,
                                  seed=seed, device="cpu").base.numpy()[:n])


MUTATION_CASES = [("stream", "stream", "fixed", False),
                  ("select", "gathered", "margin", True),
                  ("auto", "auto", "margin", True)]


@pytest.mark.parametrize("case", range(len(MUTATION_CASES)))
def test_in_place_mutations_keep_the_graphs(dev, case):
    """Delete, re-upsert, an upsert of new ids into spare slots and
    compaction at the same cap write in place: after each, search_jit
    equals search bit for bit with the graphs captured before it; only the
    first delete adds keys (the live-row bitmap's presence)."""
    scan, rerank, policy, ee = MUTATION_CASES[case]
    cfg = EngineConfig(nprobe=8, rerank_mult=4, scan_impl=scan,
                       rerank_impl=rerank, probe_policy=policy,
                       margin_tau=0.4, early_exit=ee)
    ds, eng = _mutable_engine(cfg)
    n = eng.base.shape[0]
    q = ds.queries
    ids = eng.index.lists.ids
    half = torch.rand(tuple(ids.shape), generator=torch.Generator(
        device=dev).manual_seed(1), device=dev) < 0.5
    fb = pack_filter_mask(half & (ids >= 0))
    try:
        def check(what):
            for qq in (8, 32):
                _assert_bitwise(eng.search_jit(q[:qq], 10),
                                eng.search(q[:qq], 10), (what, qq))
            got = eng.search_jit(q, 10, filter_bits=fb)
            _assert_bitwise(got, eng.search(q, 10, filter_bits=fb), what)
        check("fresh")
        assert len(eng.graphs) == 3
        rng = np.random.default_rng(2)
        dead = rng.choice(n, 500, replace=False)
        assert eng.delete(dead) == 500
        check("delete")                 # the same shapes with live bits
        assert len(eng.graphs) == 6
        found = eng.search_jit(q, 10).ids
        assert not np.isin(found.cpu().numpy(), dead).any()
        assert eng.delete(rng.choice(n, 300, replace=False)) > 0
        check("second delete")
        live = np.setdiff1d(np.arange(n), dead)[:100]
        rows = _sift_rows(100, 5)
        eng.upsert(live, rows)                       # re-upsert
        check("re-upsert")
        eng.upsert(dead[:50], rows[:50] + 1.0)       # deleted ids come back
        check("upsert into spare slots")
        assert len(eng.graphs) == 6
        hit = eng.search_jit(torch.as_tensor(rows[:50] + 1.0, device=dev),
                             10)
        assert (hit.ids[:, 0].cpu().numpy() == dead[:50]).all()
        assert (hit.dists[:, 0] == 0).all()
        cap = eng.index.lists.cap
        assert eng.compact() > 0 and eng.index.lists.cap == cap
        check("compact")
        assert len(eng.graphs) == 7 and eng.graphs_dropped == 0
    finally:
        ops.clear_autotune_cache()


def test_reallocating_mutations_drop_the_graphs_and_recapture(dev):
    cfg = EngineConfig(nprobe=8, rerank_mult=4, scan_impl="stream",
                       rerank_impl="stream")
    ds, eng = _mutable_engine(cfg)
    q = ds.queries
    for qq in (8, 32):
        eng.search_jit(q[:qq], 10)
    gc.collect()
    n0 = fused_cache_size()
    assert len(eng.graphs) == 2
    cap = eng.index.lists.cap
    eng.compact(cap=2 * cap)                         # another cap
    assert len(eng.graphs) == 0 and eng.graphs_dropped == 2
    assert fused_cache_size() == n0 - 2
    for qq in (8, 32):
        _assert_bitwise(eng.search_jit(q[:qq], 10), eng.search(q[:qq], 10))
    assert len(eng.graphs) == 2
    n = eng.base.shape[0]
    rows = _sift_rows(3, 6)
    eng.upsert(np.array([n, n + 1, n + 300]), rows)  # the base grows
    assert eng.base.shape[0] == -(-(n + 301) // 256) * 256
    assert len(eng.graphs) == 0 and eng.graphs_dropped == 4
    _assert_bitwise(eng.search_jit(q, 10), eng.search(q, 10))
    hit = eng.search_jit(torch.as_tensor(rows, device=dev), 10)
    assert hit.ids[:, 0].tolist() == [n, n + 1, n + 300]
    assert len(eng.graphs) == 2


def test_a_writer_leaves_the_graphs_of_an_engine_over_its_index(dev):
    """Two engines over one index: the writer's first write clones what it
    mutates, so the reader's captured graphs keep serving its unchanged
    index, bit for bit, and nothing of the reader's is dropped."""
    cfg = EngineConfig(nprobe=8, rerank_mult=4, scan_impl="stream",
                       rerank_impl="stream")
    ds, eng, _, _ = _graph_setup()
    reader = SearchEngine(eng.index, base=eng.base,
                          base_norms=eng.base_norms, config=cfg)
    writer = SearchEngine(eng.index, base=eng.base,
                          base_norms=eng.base_norms, config=cfg)
    q = ds.queries
    before = reader.search_jit(q, 10)
    writer.search_jit(q, 10)
    ids = eng.index.lists.ids.clone()
    n = eng.base.shape[0]
    assert writer.delete(np.arange(0, n, 3)) > 0
    writer.upsert(np.arange(1, 600, 3), _sift_rows(200, 7))
    writer.compact()
    assert writer.graphs_dropped == 1
    assert torch.equal(eng.index.lists.ids, ids)
    after = reader.search_jit(q, 10)
    _assert_bitwise(after, before, "reader")
    _assert_bitwise(after, reader.search(q, 10), "reader eager")
    assert len(reader.graphs) == 1 and reader.graphs_dropped == 0
    _assert_bitwise(writer.search_jit(q, 10), writer.search(q, 10), "writer")


def test_graph_readers_during_mutation_see_one_epoch_each(dev):
    """Threads on their own streams replay search_jit while the main thread
    deletes, upserts and compacts in place; every result equals the result
    of one epoch between the ones read before and after the call."""
    cfg = EngineConfig(nprobe=8, rerank_mult=4, scan_impl="stream",
                       rerank_impl="stream")
    ds, serial = _mutable_engine(cfg)
    q = ds.queries
    n = serial.base.shape[0]
    rng = np.random.default_rng(9)
    program = []
    for i in range(6):
        sel = np.sort(rng.choice(np.arange(1000, 3000), 40, replace=False))
        program.append(("delete", sel))
        program.append(("upsert", sel, _sift_rows(40, 20 + i)))
    program.append(("compact",))

    def apply(eng, op):
        if op[0] == "delete":
            eng.delete(op[1])
        elif op[0] == "upsert":
            eng.upsert(op[1], op[2])
        else:
            eng.compact()
    _, eng = _mutable_engine(cfg)
    want = {serial.epoch: serial.search(q, 10)}
    for op in program:
        apply(serial, op)
        want[serial.epoch] = serial.search(q, 10)
    torch.cuda.synchronize()
    eng.search_jit(q, 10)
    errors, seen = [], []
    done = threading.Event()

    def reader():
        with torch.cuda.stream(torch.cuda.Stream()):
            while not done.is_set():
                e0 = eng.epoch
                got = eng.search_jit(q, 10)
                e1 = eng.epoch
                hits = [e for e in range(e0, e1 + 1)
                        if torch.equal(got.ids, want[e].ids)
                        and torch.equal(got.dists, want[e].dists)]
                seen.append(hits[0] if hits else -1)
                if not hits:
                    errors.append((e0, e1))

    threads = [threading.Thread(target=reader) for _ in range(3)]
    for t in threads:
        t.start()
    try:
        for op in program:
            k = len(seen)
            apply(eng, op)
            while len(seen) < k + 3 and not done.is_set():
                done.wait(0.001)
    finally:
        done.set()
        for t in threads:
            t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[:5]
    assert len(set(seen)) >= len(program) // 2
    assert eng.graphs_dropped == 0 and n == eng.base.shape[0]


def test_encode_rows_is_batch_independent_on_the_card(dev):
    """The fixed 256-row encoder on the card: a row gives the same bits at
    positions 0, 17 and 255 of a chunk and across a chunk boundary, with
    centroids in one block (nlist 64) and in two padded ones (nlist
    1500, D 128)."""
    for nlist, d, m in ((64, 32, 8), (1500, 128, 16)):
        rng = np.random.default_rng(nlist)
        cen = torch.as_tensor(rng.normal(size=(nlist, d)) * 10,
                              dtype=torch.float32, device=dev)
        cb = PQCodebook(torch.as_tensor(rng.normal(size=(m, 16, d // m)),
                                        dtype=torch.float32, device=dev))
        rows = (rng.normal(size=(600, d)) * 10).astype(np.float32)
        a_all, p_all = tivf.encode_rows(cen, cb, rows)
        for pos in (0, 17, 255, 256, 300):
            batch = (rng.normal(size=(max(pos + 1, 257), d)) * 10).astype(
                np.float32)
            batch[pos] = rows[7]
            a, p = tivf.encode_rows(cen, cb, batch)
            assert a[pos] == a_all[7] and (p[pos] == p_all[7]).all(), pos
        for lo, hi in ((0, 1), (17, 273), (255, 257), (0, 600)):
            a, p = tivf.encode_rows(cen, cb, rows[lo:hi])
            assert (a == a_all[lo:hi]).all() and (p == p_all[lo:hi]).all()


# ---------------------------------------------------------------------------
# the coarse zoo and sharding on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("coarse", ["hnsw", "tree"])
def test_coarse_zoo_graph_equals_eager_and_the_host(dev, coarse):
    """An HNSW (its beam: 2·ef fixed iterations of small ops, scatters for
    the visited mask) or tree engine captured as a graph: bit for bit
    ``search``, at each bucket, namespaced too; K1 and K2 launched; no
    repeated probe; the same quantizer on the host routes and answers
    alike."""
    ds, eng, member, request = _graph_setup()
    cfg = EngineConfig(nprobe=8, rerank_mult=4, scan_impl="stream",
                       rerank_impl="stream",
                       ef=32 if coarse == "hnsw" else 64)
    zeng = SearchEngine(eng.index, base=eng.base, base_norms=eng.base_norms,
                        config=cfg, namespaces=member, coarse=coarse)
    fk.launches = rk.launches = 0
    for qq in (1, 8, 32):
        q = ds.queries[:qq]
        _assert_bitwise(zeng.search_jit(q, 10), zeng.search(q, 10), qq)
    ns = request(1)["namespaces"]
    got = zeng.search_jit(ds.queries, 10, namespaces=ns)
    _assert_bitwise(got, zeng.search(ds.queries, 10, namespaces=ns), "ns")
    _owned(zeng, got, ns)
    assert fk.launches > 0 and rk.launches > 0
    probes = zeng.select_probes(ds.queries, 8)
    s = torch.sort(probes, dim=1).values
    assert not bool(((s[:, 1:] == s[:, :-1]) & (s[:, 1:] >= 0)).any())
    # the same quantizer on the host: the beam's float sums round their
    # own way there, so probes and results agree up to near ties
    host = interop.engine_from_arrays(interop.arrays_from_engine(zeng),
                                      config=cfg, device="cpu")
    assert host.coarse_kind == coarse
    hp = host.select_probes(ds.queries.cpu(), 8)
    assert float((hp[:, :, None] == probes.cpu()[:, None, :]).any(-1)
                 .float().mean()) > 0.95
    want = host.search(ds.queries.cpu(), 10)
    res = zeng.search_jit(ds.queries, 10)
    assert float((res.ids.cpu() == want.ids).float().mean()) > 0.95


def test_sharded_engine_on_the_card(dev):
    """Shards in turn on the card: one shard == the single-host engine
    tie-aware within the K2 tolerance; every list probed without re-rank ==
    the single-host engine; a write program through the shards leaves no
    deleted id and equals the single-host engine after the same program,
    sharded afresh; K1 and K2 launched per shard."""
    from repro_torch.engine import ShardedEngine
    ds, eng, _, _ = _graph_setup()
    cfg = EngineConfig(nprobe=8, rerank_mult=4, scan_impl="stream",
                       rerank_impl="stream")
    single = SearchEngine(eng.index, base=eng.base,
                          base_norms=eng.base_norms, config=cfg)
    q = ds.queries
    tol = 1e-6 * float((q * q).sum(1).max() + eng.base_norms.max())

    def close(a, b):
        np.testing.assert_allclose(a.dists.cpu().numpy(),
                                   b.dists.cpu().numpy(), rtol=1e-5,
                                   atol=tol)
        same = (a.ids == b.ids).float().mean()
        assert float(same) > 0.98, float(same)

    fk.launches = rk.launches = 0
    close(ShardedEngine(single, 1).search(q, 10), single.search(q, 10))
    sh = ShardedEngine(single, 4)
    assert fk.launches > 0 and rk.launches > 0
    nlist = eng.index.lists.nlist
    close(sh.search(q, 10, nprobe=sh.lists_s.nlist, rerank_mult=0),
          single.search(q, 10, nprobe=nlist, rerank_mult=0))
    mut = SearchEngine(eng.index, base=eng.base, base_norms=eng.base_norms,
                       config=cfg)
    rng = np.random.default_rng(3)
    n = eng.base.shape[0]
    dead = rng.choice(n, 300, replace=False)
    new = torch.round(torch.as_tensor(
        rng.normal(size=(200, eng.base.shape[1])) * 20 + 60,
        dtype=torch.float32, device=dev))
    for e in (sh, mut):
        assert e.delete(dead) == 300
        e.upsert(np.arange(n, n + 200), new)
    got = sh.search(q, 10)
    assert not np.isin(got.ids.cpu().numpy(), dead).any()
    close(got, ShardedEngine(mut, 4).search(q, 10))
    hit = sh.search(new[:16], 10)
    assert torch.equal(hit.ids[:, 0].cpu(),
                       torch.arange(n, n + 16, dtype=torch.int32))
    assert sh.compact() == 300
    close(sh.search(q, 10), ShardedEngine(mut, 4).search(q, 10))


# ---------------------------------------------------------------------------
# durable serving on the card: the loop's graphs, open_engine, the WAL
# ---------------------------------------------------------------------------

STREAM_CFG = EngineConfig(nprobe=8, rerank_mult=4, scan_impl="stream",
                          rerank_impl="stream")


def test_serving_loop_serves_graph_replays_and_counts_its_own(dev):
    """The loop warms one graph a bucket on its own engine, serves each
    full batch bit for bit as search_jit of that batch, and its compiles
    count its own engine's captures only (a second loop's engine, as a
    standby's would, counts in its own)."""
    from repro_torch.serving import ServingLoop
    ds, mut = _mutable_engine(STREAM_CFG)
    _, other = _mutable_engine(STREAM_CFG)
    q = ds.queries[:8].cpu().numpy()
    a = ServingLoop(mut, max_wait_s=0.05).start(warmup=True)
    b = ServingLoop(other, buckets=(1, 8), max_wait_s=0.05)
    try:
        assert a.metrics().compiles == 4 and len(mut.graphs) == 4
        b.start(warmup=True)
        assert a.metrics().compiles == 4 and b.metrics().compiles == 2
        fk.launches = rk.launches = 0
        got = [f.result(timeout=60)
               for f in [a.submit(q[i], k=10) for i in range(8)]]
        assert fk.launches > 0 and rk.launches > 0  # the replay ran K1, K2
        want = mut.search_jit(torch.from_numpy(q), 10)
        np.testing.assert_array_equal(np.stack([r.ids for r in got]),
                                      want.ids.cpu().numpy())
        np.testing.assert_array_equal(np.stack([r.dists for r in got]),
                                      want.dists.cpu().numpy())
        assert got[0].codes_scanned == int(want.stats.codes_scanned[0])
        m = a.metrics()
        assert m.compiles == 4 and m.bucket_counts[8] >= 1
        # a filter on the engine's device; a write between batches
        a.set_filter(pack_filter_mask(mut.index.lists.ids >= 0))
        assert a.filter_bits.device.type == "cuda"
        a.delete(np.arange(100))
        r = a.submit(q[0], k=10).result(timeout=60)
        assert not np.isin(r.ids, np.arange(100)).any()
    finally:
        a.close()
        b.close()


def test_open_engine_on_the_card_is_bit_for_bit(dev, tmp_path):
    from repro_torch import persist
    ds, mut = _mutable_engine(STREAM_CFG)
    persist.ensure_attached(mut, str(tmp_path))
    q = ds.queries
    rows = torch.as_tensor(_sift_rows(300, 11), dtype=torch.float32)
    mut.upsert(np.arange(20_000, 20_300), rows)
    mut.delete(np.arange(0, 500, 3))
    persist.save_snapshot(mut, str(tmp_path))
    mut.upsert(np.arange(5, 25), rows[:20] + 1)
    mut.compact()
    mut.search_jit(q, 10)
    rec, info = persist.open_engine(str(tmp_path), attach=False)
    assert rec.device.type == "cuda" and info.replayed == 2
    for x, y in zip(rec.index.lists, mut.index.lists):
        assert (x is None and y is None) or torch.equal(x, y)
    assert torch.equal(rec.base, mut.base)
    assert torch.equal(rec.base_norms, mut.base_norms)
    assert (rec.epoch, rec.n_tombstones) == (mut.epoch, mut.n_tombstones)
    _assert_bitwise(rec.search_jit(q, 10), mut.search_jit(q, 10))
    _assert_bitwise(rec.search(q, 10), mut.search(q, 10))


def test_a_fenced_write_leaves_the_card_engine_and_its_graphs(dev, tmp_path):
    """Durable before visible on the card: a fenced append raises before
    any in-place write, so the graphs, the state and the results stay."""
    from repro_torch import persist
    ds, mut = _mutable_engine(STREAM_CFG)
    persist.ensure_attached(mut, str(tmp_path))
    q = ds.queries
    before = mut.search_jit(q, 10)
    graphs0, epoch0 = len(mut.graphs), mut.epoch
    transport = persist.PipeTransport()
    transport.bump_term(1, start_seq=1)
    mut._wal.guard = persist.make_fence_guard(transport, 0)
    rows = torch.as_tensor(_sift_rows(10, 12), dtype=torch.float32)
    for op in (lambda: mut.upsert(np.arange(3, 13), rows),
               lambda: mut.delete(np.arange(50)),
               lambda: mut.compact()):
        with pytest.raises(persist.FencedError):
            op()
    assert (len(mut.graphs), mut.epoch, mut._wal.last_seq) == (graphs0,
                                                              epoch0, 0)
    _assert_bitwise(mut.search_jit(q, 10), before)


# ---------------------------------------------------------------------------
# K8: PQ decode attention
# ---------------------------------------------------------------------------

# K8's output against its plain version, relative to the largest |value|
# of each (batch row, head): f32 sums in another order (the kernel's
# 256-position splits, combined, against the plain 2,048-position chunks)
# at 1e-5; in bf16 four units in the last place (2**-6): each side's
# rounding of the output, the plain version's rounding of each chunk's
# value sum to bf16, and p rounded to bf16 at another max (a split's)
K8_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -6}


def _k8_inputs(seed, dev, *, b, smax, kv, g, m, dsub, positions, q8,
               cb_dtype, out_dtype):
    from repro_torch.models import kvcache as tkvc
    rng = np.random.default_rng(seed)
    hd = m * dsub
    q = torch.as_tensor(rng.normal(0, 1, (b, kv * g, hd)), dtype=torch.float32,
                        device=dev).to(out_dtype)
    k_codes, v_codes = (torch.as_tensor(
        rng.integers(0, 256, (b, smax, kv, m // 2), dtype=np.uint8),
        device=dev) for _ in range(2))
    k_cb, v_cb = (torch.as_tensor(rng.normal(0, 1, (kv, m, 16, dsub)),
                                  dtype=torch.float32, device=dev).to(cb_dtype)
                  for _ in range(2))
    lut = tkvc._build_ip_lut(q.reshape(b, kv, g, hd), k_cb) / np.sqrt(hd)
    if q8:
        table, scale, bias = tkvc._quantize(lut)
    else:
        table, scale, bias = lut.contiguous(), None, None
    position = torch.as_tensor(np.asarray(positions, np.int32), device=dev)
    return table, scale, bias, k_codes, v_codes, v_cb, position


def _k8_close(got, want, dtype):
    got, want = got.float(), want.float()
    scale = want.abs().amax(-1, keepdim=True)
    err = (got - want).abs()
    assert bool((err <= K8_TOL[dtype] * scale).all()), float(
        (err / scale.clamp_min(1e-30)).max())


# (b, smax, kv, g, m, dsub, positions, chunk): qwen3-1.7b's decode shapes
# (g = 2, M = 64, hd = 128) at the PQ run's positions; zamba2-2.7b's shared
# attention (g = 1, M = 40, hd = 80: 20-byte rows copied 4 bytes at a
# time, 40 product units in 6 groups); starcoder2-15b's g = 12 (M = 64,
# hd = 128); position 0, Smax - 1, -1 (nothing live) and beyond Smax; g =
# 1 (qwen1.5, MHA), g = 8; M/2 = 3 (byte loads) and 4 (4-byte copies); hd
# = 16 (the smoke configs) and 256; the MoE and frontend archs' shapes:
# dbrx-132b (KV 8, g 6, M 64, hd 128), llama4-scout (KV 8, g 5),
# internvl2-1b (KV 2, g 7, M 32, hd 64: 16-byte rows) and musicgen-medium
# (KV 24, g 1, M 32, hd 64). The split pass's edges (splits of 256
# positions): positions at a split's boundary (S - 1, S, S + 1, 2S - 1,
# 2S), Smax not a multiple of the split (300, 257, 600, 64), every split
# dead, every split but the first dead, and one-dim product units (dsub 1
# and 3)
K8_CASES = [(8, 4096, 8, 2, 64, 2, [2048 + i for i in range(0, 64, 9)], 2048),
            (8, 4096, 32, 1, 40, 2, [2048 + i for i in range(0, 40, 5)],
             2048),
            (2, 1024, 4, 12, 64, 2, [777, 1023], 512),
            (1, 300, 1, 12, 40, 2, [299], 300),
            (2, 512, 2, 2, 64, 2, [0, 511], 256),
            (3, 300, 2, 1, 8, 2, [-1, 299, 1000], 300),
            (2, 257, 1, 8, 6, 4, [256, 3], 257),
            (2, 64, 4, 1, 8, 2, [63, 17], 16),
            (1, 1024, 2, 4, 128, 2, [777], 512),
            (8, 4096, 8, 6, 64, 2, [2048 + i for i in range(0, 16, 2)],
             2048),
            (8, 4096, 8, 5, 64, 2, [0, 1, 255, 256, 2063, 3000, 4095, 4100],
             2048),
            (8, 4096, 2, 7, 32, 2, [2048 + i for i in range(0, 64, 9)],
             2048),
            (8, 4096, 24, 1, 32, 2, [2048 + i for i in range(0, 64, 9)],
             2048),
            (5, 1024, 2, 2, 16, 2, [255, 256, 257, 511, 512], 512),
            (3, 600, 3, 3, 32, 2, [511, 512, 599], 600),
            (2, 4096, 8, 2, 64, 2, [-1, -1], 2048),
            (2, 4096, 8, 2, 64, 2, [0, 255], 2048),
            (4, 4096, 32, 1, 40, 2, [255, 256, 257, 4095], 2048),
            (2, 300, 2, 3, 8, 1, [299, 100], 300),
            (2, 512, 2, 2, 6, 3, [256, 40], 512)]


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("q8", [True, False])
@pytest.mark.parametrize("case", range(len(K8_CASES)))
def test_k8_kernel_matches_plain(dev, case, q8, out_dtype):
    b, smax, kv, g, m, dsub, positions, chunk = K8_CASES[case]
    cb_dtype = out_dtype
    args = _k8_inputs(case, dev, b=b, smax=smax, kv=kv, g=g, m=m, dsub=dsub,
                      positions=positions, q8=q8, cb_dtype=cb_dtype,
                      out_dtype=out_dtype)
    scores = torch.full((b, kv, g, smax), float("-inf"), device=dev)
    before = pqk.launches
    got = pqk.pq_decode(*args, chunk=chunk, out_dtype=out_dtype,
                        scores=scores)
    torch.cuda.synchronize()
    assert pqk.launches == before + 1
    want = pqk.pq_decode_plain(*args, chunk=chunk, out_dtype=out_dtype)
    assert got.shape == want.shape and got.dtype == out_dtype
    _k8_close(got, want, out_dtype)
    # the kernel's own order (splits, then the combine) in plain PyTorch:
    # its error printed as a diagnostic, and held at the same tolerance
    twin = pqk.pq_decode_plain(*args, chunk=chunk, out_dtype=out_dtype,
                               split=pqk.SPLIT)
    scale = want.float().abs().amax(-1, keepdim=True).clamp_min(1e-30)
    print(f"K8 case {case}: against the split-order twin "
          f"{float(((got.float() - twin.float()).abs() / scale).max()):.3e}"
          f", against the reference order "
          f"{float(((got.float() - want.float()).abs() / scale).max()):.3e}")
    _k8_close(got, twin, out_dtype)
    # each live position's score: bit for bit from the i32 sums (q8), the
    # f32 LUT's sums within 1e-5; dead positions never written
    table, scale, bias, k_codes = args[:4]
    plain_s = pqk.adc_scores(table, scale, bias, k_codes)
    live = (torch.arange(smax, device=dev)[None]
            <= args[6].long()[:, None])[:, None, None, :].expand_as(scores)
    assert bool(torch.isinf(scores[~live]).all())
    if q8:
        assert torch.equal(scores[live], plain_s[live])
    else:
        torch.testing.assert_close(scores[live], plain_s[live], rtol=1e-5,
                                   atol=1e-5)


def test_k8_mixed_codebook_and_output_types(dev):
    """bf16 codebooks under an f32 query (the f32 smoke configs serve with
    calibrated bf16 codebooks) and f32 codebooks under bf16."""
    for cb_dtype, out_dtype in ((torch.bfloat16, torch.float32),
                                (torch.float32, torch.bfloat16)):
        args = _k8_inputs(40, dev, b=2, smax=128, kv=2, g=2, m=8, dsub=2,
                          positions=[100, 127], q8=True, cb_dtype=cb_dtype,
                          out_dtype=out_dtype)
        got = pqk.pq_decode(*args, chunk=64, out_dtype=out_dtype)
        want = pqk.pq_decode_plain(*args, chunk=64, out_dtype=out_dtype)
        _k8_close(got, want, torch.bfloat16)


def test_k8_smem_mirror_equals_the_kernels_export(dev):
    lib = _build.load_library()
    fn = lib.repro_pq_decode_attention_smem
    for g in (1, 2, 3, 7, 8, 12):
        for m, hd in ((2, 2), (6, 24), (6, 18), (8, 8), (8, 16), (32, 64),
                      (40, 80), (64, 128), (128, 256)):
            for q8 in (0, 1):
                assert fn(g, m, hd, q8) == pqk.smem_bytes(g, m, hd, bool(q8))
    combine = lib.repro_pq_decode_combine_smem
    for smax in (1, 16, 255, 256, 257, 300, 600, 4096, 4097, 1 << 20):
        assert combine(smax) == pqk.combine_smem_bytes(smax)


def test_k8_graph_replay_across_split_boundaries_equals_eager(dev):
    """K8 alone captured in a CUDA graph: the position moves in its static
    buffer across split boundaries (the grid is fixed by Smax), and every
    replay equals an eager call at the new position bit for bit."""
    for q8, dtype in ((True, torch.bfloat16), (False, torch.float32)):
        args = _k8_inputs(50, dev, b=4, smax=1024, kv=2, g=3, m=32, dsub=2,
                          positions=[200, 250, 255, 10], q8=q8,
                          cb_dtype=dtype, out_dtype=dtype)
        position = args[6]

        def call():
            return pqk.pq_decode(*args, chunk=512, out_dtype=dtype)

        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            call()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = call()
        for new in ([255, 256, 257, 0], [511, 512, 513, 1023],
                    [-1, 300, 700, 1100], [256, 255, 767, 768]):
            position.copy_(torch.tensor(new, dtype=torch.int32))
            graph.replay()
            want = call()
            torch.cuda.synchronize()
            assert torch.equal(out, want), (q8, new)
            _k8_close(out, pqk.pq_decode_plain(*args, chunk=512,
                                               out_dtype=dtype), dtype)


def test_k8_wrapper_raises_on_what_the_kernel_does_not_take(dev):
    args = list(_k8_inputs(41, dev, b=2, smax=64, kv=2, g=2, m=8, dsub=2,
                           positions=[3, 4], q8=True,
                           cb_dtype=torch.float32, out_dtype=torch.float32))
    with pytest.raises(ValueError):     # mixed devices
        pqk.pq_decode(*args[:6], args[6].cpu(), chunk=64,
                      out_dtype=torch.float32)
    with pytest.raises(ValueError):     # more than 12 query heads a KV head
        big = _k8_inputs(42, dev, b=1, smax=16, kv=1, g=13, m=8, dsub=2,
                         positions=[3], q8=True, cb_dtype=torch.float32,
                         out_dtype=torch.float32)
        pqk.pq_decode(*big, chunk=16, out_dtype=torch.float32)


def test_lm_decode_on_the_card_matches_the_host(dev):
    """qwen3-smoke (f32) through prefill and three decode steps on both
    caches, the PQ one through K8: the card's logits against the host's.
    The PQ cache's codebooks are held in f32 here: with bf16 ones the plain
    version rounds each chunk's value sum to bf16 and K8 does not (that
    difference is held by the K8 tests at their bf16 tolerance)."""
    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models import model as tmodel
    cfg = configs.get_smoke_config("qwen3-1.7b")
    host = tmodel.init_lm(cfg, generator=torch.Generator().manual_seed(0),
                          device="cpu")
    card = interop.lm_params_from_arrays(interop.arrays_from_lm_params(host),
                                         cfg, device=dev)
    prompts = torch.as_tensor(np.random.default_rng(43).integers(
        0, cfg.vocab, (2, 64), dtype=np.int32))
    for pq_on in (False, True):
        c = cfg.replace(kv_pq=pq_on)
        caches = {}
        if pq_on:
            pqc = serve.calibrate_pq_cache(torch.Generator().manual_seed(1),
                                           host, c, 2, 68)
            pqc = pqc._replace(k_cb=pqc.k_cb.float(), v_cb=pqc.v_cb.float())
            caches = {"cpu": pqc, "cuda": pqc._replace(
                **{f: getattr(pqc, f).to(dev) for f in pqc._fields})}
        logits = {}
        for where, model in (("cpu", host), ("cuda", card)):
            toks = prompts.to(model.embedding.device)
            lg, cache = tmodel.prefill(model, toks, c, max_seq=68,
                                       pq_cache=caches.get(where))
            seq = [lg]
            for i in range(3):   # the same tokens on both
                pos = torch.full((2,), 64 + i, dtype=torch.int32,
                                 device=toks.device)
                lg, cache = tmodel.decode_step(model, cache, toks[:, i], pos,
                                               c)
                seq.append(lg)
            logits[where] = torch.stack(seq).cpu()
        torch.testing.assert_close(logits["cuda"], logits["cpu"], rtol=1e-3,
                                   atol=1e-3)


@pytest.mark.parametrize("arch", ["dbrx-132b", "llama4-scout-17b-a16e",
                                  "internvl2-1b", "musicgen-medium"])
def test_moe_and_frontend_lm_on_the_card_matches_the_host(dev, arch):
    """The MoE and frontend smoke configs (f32) on the card against the
    host: the forward (with the frontend's embeddings where the config has
    a frontend), its aux loss, and an exact prefill then three decode
    steps. MoE routing on the card sees the same gates up to f32 rounding,
    so its drops and ties are the host's."""
    from repro_torch import configs
    from repro_torch.models import model as tmodel
    cfg = configs.get_smoke_config(arch)
    host = tmodel.init_lm(cfg, generator=torch.Generator().manual_seed(0),
                          device="cpu")
    card = interop.lm_params_from_arrays(interop.arrays_from_lm_params(host),
                                         cfg, device=dev)
    rng = np.random.default_rng(45)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 64),
                                           dtype=np.int32))
    emb = (torch.as_tensor(rng.normal(0, 1, (2, cfg.frontend_len,
                                             cfg.d_model)),
                           dtype=torch.float32) if cfg.frontend != "none"
           else None)
    out = {}
    for where, model in (("cpu", host), ("cuda", card)):
        d = model.embedding.device
        e = None if emb is None else emb.to(d)
        logits, aux = tmodel.forward(model, prompts.to(d), cfg,
                                     frontend_embeds=e)
        lg, cache = tmodel.prefill(model, prompts.to(d), cfg, max_seq=68,
                                   frontend_embeds=e)
        seq = [lg]
        for i in range(3):
            pos = torch.full((2,), 64 + i, dtype=torch.int32, device=d)
            lg, cache = tmodel.decode_step(model, cache, prompts[:, i].to(d),
                                           pos, cfg)
            seq.append(lg)
        out[where] = (logits.cpu(), aux.cpu(), torch.stack(seq).cpu())
    for got, want in zip(out["cuda"], out["cpu"]):
        torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3)


# ---------------------------------------------------------------------------
# the LM decode step as a CUDA graph
# ---------------------------------------------------------------------------

def _lm_caches(dev, arch, kind, dtype, b=2, s=40, max_seq=48):
    """A smoke model on the card in ``dtype``, its prompts, and two caches
    prefilled alike (exact, or PQ with calibrated codebooks)."""
    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models import model as tmodel
    cfg = configs.get_smoke_config(arch).replace(kv_pq=kind == "pq")
    params = tmodel.init_lm(cfg, generator=torch.Generator(
        device=dev).manual_seed(0), device=dev, dtype=dtype)
    prompts = torch.as_tensor(np.random.default_rng(44).integers(
        0, cfg.vocab, (b, s), dtype=np.int32), device=dev)
    pq = None
    if kind == "pq":
        pq = (serve.calibrate_pq_cache(torch.Generator().manual_seed(1),
                                       params, cfg, b, max_seq)
              if cfg.block_type == "attn"
              else serve.calibrate_hybrid_codebooks(
                  torch.Generator().manual_seed(1), params, cfg, prompts))
    # the attention family's prefill fills a PQ cache's codes in place:
    # each prefill gets codes of its own
    caches = [tmodel.prefill(params, prompts, cfg, max_seq=max_seq,
                             pq_cache=pq if not hasattr(pq, "_replace")
                             else pq._replace(k_codes=pq.k_codes.clone(),
                                              v_codes=pq.v_codes.clone()))
              for _ in range(2)]
    return cfg, params, prompts, caches


def _cache_list(cache):
    from repro_torch.models.decode_graph import cache_tensors
    return cache_tensors(cache)


LM_GRAPH_CASES = [("qwen3-1.7b", "exact"), ("qwen3-1.7b", "pq"),
                  ("zamba2-2.7b", "exact"), ("zamba2-2.7b", "pq"),
                  ("rwkv6-3b", "exact"), ("dbrx-132b", "exact"),
                  ("dbrx-132b", "pq"), ("llama4-scout-17b-a16e", "exact"),
                  ("llama4-scout-17b-a16e", "pq"), ("internvl2-1b", "pq"),
                  ("musicgen-medium", "exact")]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", LM_GRAPH_CASES)
def test_lm_decode_graph_equals_the_eager_step(dev, case, dtype):
    """A replayed decode step equals the eager step bit for bit: the logits
    and every cache tensor after each of several steps."""
    from repro_torch.models import model as tmodel
    from repro_torch.models.decode_graph import DecodeGraph
    arch, kind = case
    cfg, params, prompts, caches = _lm_caches(dev, arch, kind, dtype)
    (lg_e, eager), (lg_g, cache_g) = caches
    assert torch.equal(lg_e, lg_g)
    graph = DecodeGraph(params, cache_g, cfg, prompts.shape[0])
    tok = torch.argmax(lg_e[:, :cfg.vocab], -1)
    for i in range(5):
        pos = torch.full((prompts.shape[0],), prompts.shape[1] + i,
                         dtype=torch.int32, device=dev)
        want, _ = tmodel.decode_step(params, eager, tok, pos, cfg)
        got = graph.step(tok, pos)
        assert torch.equal(got, want), (case, i)
        for a, b in zip(_cache_list(cache_g), _cache_list(eager)):
            assert torch.equal(a, b), (case, i)
        tok = torch.argmax(want[:, :cfg.vocab], -1)
    assert len(graph.graphs) == 1 and graph.graphs.captures == 1
    assert graph.capture_seconds() > 0


def test_lm_decode_graph_replays_advance_the_k8_counter(dev):
    from repro_torch.models.decode_graph import DecodeGraph
    for arch in ("qwen3-1.7b", "zamba2-2.7b"):
        cfg, params, prompts, caches = _lm_caches(dev, arch, "pq",
                                                  torch.float32)
        lg, cache = caches[0]
        graph = DecodeGraph(params, cache, cfg, prompts.shape[0])
        tok = torch.argmax(lg[:, :cfg.vocab], -1)
        per_step = (cfg.n_layers if cfg.block_type == "attn"
                    else cfg.n_layers // cfg.shared_attn_every)
        for i in range(3):
            before = pqk.launches
            pos = torch.full((prompts.shape[0],), prompts.shape[1] + i,
                             dtype=torch.int32, device=dev)
            tok = torch.argmax(graph.step(tok, pos)[:, :cfg.vocab], -1)
            # the first step's capture is recorded, not counted; its
            # eager warm-up launches the kernel for real
            assert pqk.launches - before == per_step * (2 if i == 0 else 1)


def test_serve_batch_on_the_card_replays_one_graph(dev, monkeypatch):
    from repro_torch.launch import serve
    from repro_torch.models import model as tmodel
    made = []

    class Recording(serve.DecodeGraph):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(serve, "DecodeGraph", Recording)
    for arch in ("qwen3-1.7b", "zamba2-2.7b", "rwkv6-3b", "dbrx-132b",
                 "internvl2-1b"):
        cfg, params, prompts, _ = _lm_caches(dev, arch, "exact",
                                             torch.float32)
        made.clear()
        stats = {}
        toks, logits = serve.serve_batch(cfg, params, prompts, 6,
                                         return_logits=True, stats=stats)
        assert len(made) == 1 and made[0].graphs.captures == 1
        assert stats["capture_s"] > 0
        # the same tokens as an eager loop on the card
        lg, cache = tmodel.prefill(params, prompts, cfg, max_seq=46)
        want = [torch.argmax(lg[:, :cfg.vocab], -1)]
        for i in range(5):
            pos = torch.full((prompts.shape[0],), prompts.shape[1] + i,
                             dtype=torch.int32, device=dev)
            lg, cache = tmodel.decode_step(params, cache, want[-1], pos, cfg)
            assert torch.equal(logits[:, i + 1], lg), (arch, i)
            want.append(torch.argmax(lg[:, :cfg.vocab], -1))
        assert torch.equal(toks, torch.stack(want, 1)), arch
    with pytest.raises(NotImplementedError, match="attention family only"):
        cfg, params, prompts, _ = _lm_caches(dev, "zamba2-2.7b", "exact",
                                             torch.float32)
        serve.serve_batch(cfg.replace(kv_pq=True), params, prompts, 4)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

# the card's gradients against the host's, of each leaf's largest |value|
# (1e-4 by default): dbrx-smoke has no qk_norm, so on the reference's init
# its attention is near one-hot and the softmax backward multiplies the
# two devices' f32 summation-order differences (7.0e-4 measured on layer
# 0's wq at 4 layers, B 4 x 64)
TRAIN_GRAD_TOL = {"dbrx-132b": 2e-3}


def _train_batch(cfg, dev, b=4, s=64, step=0):
    from repro_torch.data import tokens as ttok
    pc = ttok.TokenPipelineConfig(vocab=cfg.vocab, seq_len=s, global_batch=b)
    return dict(ttok.batch_at_step(pc, step, dev)._asdict())


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "zamba2-2.7b", "rwkv6-3b",
                                  "dbrx-132b"])
def test_train_loss_on_the_card_matches_the_host(dev, arch):
    """The chunked loss (each chunk checkpointed, remat on) and the full
    loss agree on the card, and both with the host's, in f32; the
    gradients too."""
    from repro_torch import configs
    from repro_torch.models import layers as tll
    from repro_torch.models import model as tmodel
    cfg = configs.get_smoke_config(arch).replace(n_layers=4, remat="group:2")
    out = {}
    for where in ("cpu", dev):
        model = tll.set_trainable(tmodel.init_lm(
            cfg, generator=torch.Generator().manual_seed(0), device=where))
        batch = _train_batch(cfg, where)
        for chunk in (0, 16):
            loss, _ = tmodel.loss_fn(model, batch,
                                     cfg.replace(loss_chunk=chunk))
            grads = torch.autograd.grad(loss, list(model.parameters()))
            out[(str(where), chunk)] = (loss.detach().cpu(),
                                        [g.cpu() for g in grads])
    want_l, want_g = out[("cpu", 0)]
    names = [n for n, _ in model.named_parameters()]
    for key, (loss, grads) in out.items():
        torch.testing.assert_close(loss, want_l, rtol=1e-5, atol=0,
                                   msg=str(key))
        err = {n: float((g - w).abs().max()) / (float(w.abs().max()) or 1.0)
               for n, g, w in zip(names, grads, want_g)}
        worst = max(err, key=err.get)
        assert err[worst] <= TRAIN_GRAD_TOL.get(arch, 1e-4), (key, worst,
                                                               err[worst])


def test_train_resume_on_the_card_is_bit_for_bit(dev, tmp_path,
                                                  monkeypatch):
    """Interrupt, restart, and the resumed run equals the uninterrupted one
    bit for bit, under deterministic algorithms, in bf16 with two
    microbatches and the chunked loss."""
    from repro_torch import configs, interop
    from repro_torch.train import train_loop
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    cfg = configs.get_smoke_config("qwen3-1.7b").replace(
        dtype="bfloat16", loss_chunk=16)
    kw = dict(steps=6, global_batch=4, seq_len=64, ckpt_every=3,
              microbatches=2, log=lambda s: None, device=dev)
    torch.use_deterministic_algorithms(True)
    try:
        full, hist = train_loop.train(cfg, ckpt_dir=str(tmp_path / "a"),
                                      **kw)
        train_loop.train(cfg, ckpt_dir=str(tmp_path / "b"),
                         **dict(kw, steps=3))
        resumed, hist2 = train_loop.train(cfg, ckpt_dir=str(tmp_path / "b"),
                                          **kw)
    finally:
        torch.use_deterministic_algorithms(False)
    assert [h["loss"] for h in hist2] == [h["loss"] for h in hist[3:]]
    a = interop.arrays_from_train_state(full)
    b = interop.arrays_from_train_state(resumed)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_train_bf16_state_round_trips_through_a_checkpoint(dev, tmp_path):
    from repro_torch import configs
    from repro_torch.train import checkpoint as tck
    from repro_torch.train import optimizer as topt
    from repro_torch.train import train_loop
    cfg = configs.get_smoke_config("zamba2-2.7b").replace(dtype="bfloat16")
    state = train_loop.init_train_state(cfg, 0, dev, grad_compress=True)
    state, _ = train_loop.make_train_step(
        cfg, topt.AdamWConfig(warmup_steps=0), 1)(
        state, _train_batch(cfg, dev))
    tck.save(str(tmp_path), 1, state)
    fresh = train_loop.init_train_state(cfg, 7, dev, grad_compress=True)
    step, fresh = tck.restore(str(tmp_path), fresh)
    assert step == 1 and fresh.opt.step.device.type == dev.type
    pairs = [*zip(state.params.parameters(), fresh.params.parameters()),
             *zip(state.opt.mu.values(), fresh.opt.mu.values()),
             *zip(state.opt.nu.values(), fresh.opt.nu.values()),
             *zip(state.ef_error.values(), fresh.ef_error.values()),
             (state.opt.step, fresh.opt.step)]
    for a, b in pairs:
        assert a.dtype == b.dtype and b.device.type == dev.type
        ints = {2: torch.int16, 4: torch.int32}[a.element_size()]
        assert torch.equal(a.view(ints), b.view(ints))


def test_train_codec_on_the_card(dev):
    """The gradient codec on the card: the error state is the target less
    its decoding, exactly, and the reconstruction error is that of the
    same codec on the host within the k-means draws' spread."""
    from repro_torch.train import grad_compress as tgc
    g = torch.from_numpy(np.random.default_rng(0).normal(
        0, 1, (4096, 8)).astype(np.float32))
    errs = []
    for where in ("cpu", dev):
        x = {"w": g.to(where)}
        dec, new_err, stats = tgc.ef_step(torch.Generator().manual_seed(0), x,
                                          tgc.init_error(x), tgc.PQGradCodec())
        assert torch.equal(new_err["w"], x["w"] - dec["w"])
        errs.append(float(torch.linalg.vector_norm(dec["w"] - x["w"])
                          / torch.linalg.vector_norm(x["w"])))
        assert stats["ratio"] > 7.5
    assert errs[1] < 1.25 * errs[0]


@pytest.mark.parametrize("kind", ["exact", "pq"])
def test_dryrun_count_of_the_smoke_decode_holds_on_the_card(dev, kind):
    """The dry-run's count of qwen3-smoke's decode step on the meta device
    against the same step replayed on the card: the replay never faster
    than 0.95 x the count's t_bound, the counted static bytes the real
    parameters' and cache's, one K8 a layer on the PQ cache."""
    from repro_torch.launch import cost_analysis as ca
    from repro_torch.launch import dryrun
    from repro_torch.models.decode_graph import DecodeGraph
    cfg, params, prompts, caches = _lm_caches(dev, "qwen3-1.7b", kind,
                                              torch.float32)
    lg, cache = caches[0]
    b, s = prompts.shape
    graph = DecodeGraph(params, cache, cfg, b)
    tok = torch.argmax(lg[:, :cfg.vocab], -1)
    pos = torch.full((b,), s, dtype=torch.int32, device=dev)
    graph.step(tok, pos)
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(20):
        graph.step(tok, pos)
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / 20
    smax = cache.k.shape[2] if kind == "exact" else cache.k_codes.shape[2]
    costs = dryrun.count_cell(cfg, "decode", b, smax, live=s + 1)
    roof = dryrun.roofline(cfg, cfg.name, "smoke", "decode", b, s + 1, costs)
    assert ms >= 0.95 * roof.t_bound * 1e3, (ms, roof.t_bound)
    assert costs.static_bytes == ca.tree_bytes(params, cache)
    assert costs.kernels.get("pq_decode_attention", 0) == (
        cfg.n_layers if kind == "pq" else 0)


# K8's sharded mode (a cache sharded on its positions over several ranks):
# (b, smax, kv, g, m, dsub, positions): qwen3-1.7b's decode shapes at the
# LM path's positions, zamba2-2.7b's g = 1 / M 40 / hd 80, starcoder2's g
# = 12, a row with nothing live, rows whose live range ends inside the
# first shard, at a shard's boundary and past Smax
K8_SHARDED_CASES = [(8, 4096, 8, 2, 64, 2, [2069 - 7 * r for r in range(8)]),
                    (4, 4096, 32, 1, 40, 2, [2047, 2048, 3071, 4095]),
                    (2, 4096, 4, 12, 64, 2, [1023, 1024]),
                    (3, 4096, 2, 2, 16, 2, [-1, 100, 5000])]


@pytest.mark.parametrize("n", [2, 4, 16])
@pytest.mark.parametrize("q8, dtype", [(True, torch.bfloat16),
                                       (False, torch.float32)])
@pytest.mark.parametrize("case", range(len(K8_SHARDED_CASES)))
def test_k8_sharded_mode_equals_one_rank_k8(dev, case, q8, dtype, n):
    """The split pass over each of n shards of the positions at its offset,
    the partials concatenated in shard order, the combine pass: the one-
    rank K8 bit for bit (every shard a multiple of 256 positions), one
    launch a pass; the plain versions of the same steps equal
    ``pq_decode_plain(split=256)`` bit for bit on the host."""
    b, smax, kv, g, m, dsub, positions = K8_SHARDED_CASES[case]
    args = _k8_inputs(100 + case, dev, b=b, smax=smax, kv=kv, g=g, m=m,
                      dsub=dsub, positions=positions, q8=q8, cb_dtype=dtype,
                      out_dtype=dtype)
    table, scale, bias, k_codes, v_codes, v_cb, position = args
    one = pqk.pq_decode(*args, chunk=smax, out_dtype=dtype)
    sl = smax // n
    before = pqk.launches
    work = torch.cat([pqk.pq_decode_split(
        table, scale, bias, k_codes[:, r * sl:(r + 1) * sl].contiguous(),
        v_codes[:, r * sl:(r + 1) * sl].contiguous(), v_cb, position,
        pos_offset=r * sl) for r in range(n)], dim=3)
    got = pqk.pq_decode_combine(work, out_dtype=dtype)
    torch.cuda.synchronize()
    assert pqk.launches == before + n + 1
    assert torch.equal(got, one), float((got.float() - one.float()).abs().max())
    host = [t.cpu() if t is not None else None for t in args]
    plain = torch.cat([pqk.plain_partials(
        *host[:3], host[3][:, r * sl:(r + 1) * sl], host[4][:, r * sl:(r + 1)
                                                            * sl],
        host[5], host[6], pos_offset=r * sl) for r in range(n)], dim=3)
    assert torch.equal(pqk.plain_combine(plain, out_dtype=dtype),
                       pqk.pq_decode_plain(*host, chunk=smax, out_dtype=dtype,
                                           split=pqk.SPLIT))
    _k8_close(got, pqk.pq_decode_plain(*args, chunk=smax, out_dtype=dtype,
                                       split=pqk.SPLIT), dtype)


def test_k8_sharded_mode_at_ragged_shards_matches_plain(dev):
    """Shards of 64 positions (not a multiple of the 256-position split):
    the kernel's passes against their plain versions over the same shards
    and against the one-rank K8, within K8's tolerance."""
    for q8, dtype in ((True, torch.bfloat16), (False, torch.float32)):
        args = _k8_inputs(120, dev, b=3, smax=1024, kv=2, g=3, m=32, dsub=2,
                          positions=[63, 500, 1023], q8=q8, cb_dtype=dtype,
                          out_dtype=dtype)
        table, scale, bias, k_codes, v_codes, v_cb, position = args
        sl = 64
        shards = [(k_codes[:, r * sl:(r + 1) * sl].contiguous(),
                   v_codes[:, r * sl:(r + 1) * sl].contiguous())
                  for r in range(16)]
        got = pqk.pq_decode_combine(torch.cat([pqk.pq_decode_split(
            table, scale, bias, *shards[r], v_cb, position, pos_offset=r * sl)
            for r in range(16)], dim=3), out_dtype=dtype)
        plain = pqk.plain_combine(torch.cat([pqk.plain_partials(
            table, scale, bias, *shards[r], v_cb, position, pos_offset=r * sl)
            for r in range(16)], dim=3), out_dtype=dtype)
        _k8_close(got, plain, dtype)
        _k8_close(got, pqk.pq_decode(*args, chunk=1024, out_dtype=dtype),
                  dtype)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", range(len(K8_SHARDED_CASES)))
def test_k8_subspace_mode_equals_one_rank_k8(dev, case, dtype, n):
    """K8's sub-space mode over n shards of M / n sub-spaces (the u8 table
    quantized whole, sliced): the shards' scoring passes summed on the
    card equal the plain i32 sums bit for bit (0 at dead positions), and
    scale x sums + bias equals the one-rank K8's live scores bit for bit;
    each shard's value pass and the combine give its head_dim slice, the
    slices concatenated within K8's tolerance of the one-rank K8 and of
    the plain passes on the same inputs; one launch a pass a shard."""
    b, smax, kv, g, m, dsub, positions = K8_SHARDED_CASES[case]
    args = _k8_inputs(140 + case, dev, b=b, smax=smax, kv=kv, g=g, m=m,
                      dsub=dsub, positions=positions, q8=True,
                      cb_dtype=dtype, out_dtype=dtype)
    table, scale, bias, k_codes, v_codes, v_cb, position = args
    scores = torch.full((b, kv, g, smax), float("-inf"), device=dev)
    one = pqk.pq_decode(*args, chunk=smax, out_dtype=dtype, scores=scores)
    ml = m // n
    subs = [slice(r * ml, (r + 1) * ml) for r in range(n)]

    def codes(c, sl):
        return c[..., sl.start // 2:sl.stop // 2].contiguous()

    before = dict(pqk.launches_by)
    sums = sum(pqk.pq_decode_scores(table[..., sl, :].contiguous(),
                                    codes(k_codes, sl), position)
               for sl in subs)
    works = [pqk.pq_decode_values(sums, scale, bias, codes(v_codes, sl),
                                  v_cb[:, sl].contiguous(), position)
             for sl in subs]
    got = torch.cat([pqk.pq_decode_combine(w, out_dtype=dtype)
                     for w in works], dim=-1)
    torch.cuda.synchronize()
    after = pqk.launches_by
    for name in ("pq_decode_scores", "pq_decode_values",
                 "pq_decode_combine"):
        assert after.get(name, 0) - before.get(name, 0) == n, name
    assert torch.equal(sums, pqk.plain_scores(table, k_codes, position))
    live = (torch.arange(smax, device=dev)[None]
            <= position[:, None].long())[:, None, None].expand_as(scores)
    got_scores = scale[..., None] * sums.float() + bias[..., None]
    assert torch.equal(got_scores[live], scores[live])
    _k8_close(got, one, dtype)
    plain = torch.cat([pqk.plain_combine(pqk.plain_values(
        sums, scale, bias, codes(v_codes, sl), v_cb[:, sl].contiguous(),
        position), out_dtype=dtype) for sl in subs], dim=-1)
    _k8_close(got, plain, dtype)


def test_k8_scores_smem_mirror_equals_the_kernels_export(dev):
    fn = _build.load_library().repro_pq_decode_scores_smem
    for g in (1, 2, 7, 12):
        for m in (2, 4, 8, 16, 32, 40, 64, 128):
            assert fn(g, m) == pqk.scores_smem_bytes(g, m)


def test_k8_combine_splits_smem_mirror_equals_the_kernels_export(dev):
    fn = _build.load_library().repro_pq_decode_combine_splits_smem
    for nsplit in (1, 2, 16, 17, 64, 4097):
        assert fn(nsplit) == pqk.combine_splits_smem_bytes(nsplit)


@pytest.mark.parametrize("seq", [32, 64])
def test_head_dim_attention_at_one_nccl_rank_is_the_meshless_one(dev, seq):
    """The head_dim branch's prefill attention (``layers._over_head_dim``:
    each rank's slice of head_dim, the partial scores of a block summed by
    an f32 all-reduce) on the card under a one-rank NCCL group, q, k and v
    placed on head_dim over the model dim: qwen3-smoke with 6 heads in
    bf16, the full path (32 positions, one chunk) and the chunked one (64),
    equal to the meshless ``chunked_causal_attention`` bit for bit (one
    rank's sum is its own partial)."""
    import socket

    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch import configs
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import layers as ll
    cfg = configs.get_smoke_config("qwen3-1.7b").replace(n_heads=6)
    g = torch.Generator(device=dev).manual_seed(seq)
    hd = cfg.resolved_head_dim
    q, k, v = (torch.randn((2, seq, h, hd), generator=g, device=dev).to(
        torch.bfloat16) for h in (6, cfg.n_kv_heads, cfg.n_kv_heads))
    want = ll.chunked_causal_attention(q, k, v, cfg)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1, device_id=torch.device(
                                "cuda", torch.cuda.current_device()))
    try:
        mesh = mesh_lib.make_host_mesh()
        place = [Replicate(), Shard(3)]
        pq, pk, pv = (distribute_tensor(t, mesh.device_mesh, place)
                      for t in (q, k, v))
        got = ll._over_head_dim(ll.chunked_causal_attention, pq, pk, pv, cfg,
                                1)
        assert tuple(got.placements) == tuple(place)
        got = got.full_tensor()
    finally:
        dist.destroy_process_group()
    assert torch.equal(got, want)


def test_a_train_cell_at_one_nccl_rank_is_the_meshless_step(dev,
                                                           monkeypatch):
    """qwen3-smoke's train cell (``dryrun.mesh_cell(..., "train")``: the
    parameters, AdamW state and batch placed by the training rules, DTensor
    autograd, the gradients at the parameters' placements) on the card
    under a one-rank NCCL group, two microbatches, under deterministic
    algorithms: the loss, the grad norm, every gradient before the update
    and every parameter and moment after it equal the meshless step's on
    the same parameters and batch bit for bit."""
    import pathlib
    import socket
    import sys

    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import model as model_lib
    sys.path.insert(0, str(pathlib.Path(__file__).parent))
    import _torch_dist_harness as harness
    cfg = configs.get_smoke_config("qwen3-1.7b")
    params = model_lib.init_lm(cfg, generator=torch.Generator(
        device=dev).manual_seed(0), device=dev)
    batch = {k: v.to(dev) for k, v in harness.train_batch(cfg).items()}
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    torch.use_deterministic_algorithms(True)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1, device_id=torch.device(
                                "cuda", torch.cuda.current_device()))
    try:
        want_g, want, want_m = harness.meshless_step(cfg, params, batch, 2)
        mesh = mesh_lib.make_host_mesh()
        cell = dryrun.mesh_cell(cfg, "train", mesh,
                                dryrun.cell_rules(cfg, "train_4k", mesh),
                                params, microbatches=2, **batch)
        seen = []
        with harness.captured_grads(seen):
            state, m = cell.step()
        for k in ("loss", "grad_norm"):
            assert torch.equal(m[k].full_tensor(), want_m[k]), k
        for name, g in seen[0].items():
            assert torch.equal(g.full_tensor(), want_g[name]), name
        wp = dict(want.params.named_parameters())
        for name, p in state.params.named_parameters():
            assert torch.equal(p.detach().full_tensor(), wp[name]), name
        for name, t in state.opt.nu.items():
            assert torch.equal(t.full_tensor(), want.opt.nu[name]), name
            assert torch.equal(state.opt.mu[name].full_tensor(),
                               want.opt.mu[name]), name
    finally:
        dist.destroy_process_group()
        torch.use_deterministic_algorithms(False)

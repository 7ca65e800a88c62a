"""The port's two kernels held against the JAX reference kernels.

On the CPU each wrapper runs its plain PyTorch version, which must equal
the Pallas kernel (run in interpret mode, as the reference's own tests run
it): K1 bit for bit, K2 bit for bit on integer-valued data (f32 exact) and
within rtol 1e-5 with tie-aware ids on random data (the two frameworks sum
the dot products in different orders). ``tests/test_torch_cuda.py`` holds
the CUDA kernels themselves to the plain versions on the card.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import fastscan_kernel as jfk
from repro.kernels import ops as jops
from repro.kernels import rerank_kernel as jrk
from repro_torch.kernels import _build
from repro_torch.kernels import fastscan_kernel as tfk
from repro_torch.kernels import mxu_kernel as tmk
from repro_torch.kernels import ops as tops
from repro_torch.kernels import rerank_kernel as trk
from repro_torch.kernels import select_kernel as tsk
from repro_torch.kernels import stream_grouped_kernel as tsgk

RTOL = 1e-5


def _t(x):
    return torch.from_numpy(np.array(x))


def _k1_inputs(seed, *, g, nlist, cap, mh, probes=None, sizes=None,
               fill=None, levels=256, lut_max=256):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, levels, (nlist, cap, mh), dtype=np.uint8)
    table = rng.integers(0, lut_max, (g, 2 * mh, 16), dtype=np.uint8)
    if sizes is None:
        sizes = rng.integers(0, cap + 1, nlist)
    sizes = np.asarray(sizes, np.int32)
    if probes is None:
        probes = rng.integers(-1, nlist, g)
    probes = np.asarray(probes, np.int32)
    bits = None
    if fill is not None:
        mask = rng.random((nlist, cap)) < fill
        w = -(-cap // 8)
        padded = np.zeros((nlist, w * 8), bool)
        padded[:, :cap] = mask
        bits = np.packbits(padded.reshape(nlist, w, 8), axis=-1,
                           bitorder="little")[..., 0]
    return table, codes, probes, sizes, bits


# (g, nlist, cap, mh, tile, keep, filter fill, probes, sizes)
K1_GRID = {
    "g1": (1, 3, 64, 4, 64, 5, None, [1], [40, 64, 0]),
    "several_tiles_ragged": (6, 5, 128, 4, 32, 6, None,
                             [0, 1, -1, 3, 3, 4], [128, 77, 0, 31, 1]),
    "empty_and_invalid_probes": (4, 4, 64, 4, 16, 3, None,
                                 [-1, 2, -1, 2], [0, 9, 0, 64]),
    "filter_0": (5, 4, 96, 4, 32, 7, 0.0, [0, 1, 2, 3, -1], None),
    "filter_50": (5, 4, 96, 4, 32, 7, 0.5, [0, 1, 1, 3, -1], None),
    "filter_100": (5, 4, 96, 4, 32, 7, 1.0, [0, 1, 2, 3, 0], None),
    "keep_gt_tile": (4, 3, 64, 4, 16, 40, 0.5, [0, 1, 2, 2], None),
    "odd_mh": (5, 4, 96, 3, 32, 5, 0.5, [3, 0, -1, 2, 2], None),
    "non_pow2_tile": (3, 3, 100, 4, 100, 9, None, [2, 0, 1], [100, 55, 3]),
    "all_invalid": (3, 2, 32, 2, 16, 4, None, [-1, -1, -1], None),
}


@pytest.mark.parametrize("case", sorted(K1_GRID))
def test_k1_plain_equals_reference_kernel(case):
    g, nlist, cap, mh, tile, keep, fill, probes, sizes = K1_GRID[case]
    table, codes, probes, sizes, bits = _k1_inputs(
        len(case), g=g, nlist=nlist, cap=cap, mh=mh, probes=probes,
        sizes=sizes, fill=fill)
    kc = max(1, min(keep, tile))
    jbits = None if bits is None else jnp.asarray(
        bits[np.maximum(probes, 0)])
    want_v, want_s = jfk.fastscan_stream_topk_grouped(
        jnp.asarray(table), jnp.asarray(codes), jnp.asarray(probes),
        jnp.asarray(sizes), kc=kc, tile_n=tile, filter_bits=jbits,
        interpret=True)
    got_v, got_s = tfk.fastscan_stream_topk_grouped(
        _t(table), _t(codes), _t(probes), _t(sizes), kc=kc, tile_n=tile,
        filter_bits=None if bits is None else _t(bits))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


@pytest.mark.parametrize("seed", range(3))
def test_k1_plain_equals_reference_on_tie_heavy_sums(seed):
    """Tiny LUT values and few distinct codes make equal ADC sums common,
    so the lowest-slot-wins order is what is being compared."""
    table, codes, probes, sizes, bits = _k1_inputs(
        seed, g=4, nlist=3, cap=64, mh=2, levels=3, lut_max=2, fill=0.7)
    want = jfk.fastscan_stream_topk_grouped(
        jnp.asarray(table), jnp.asarray(codes), jnp.asarray(probes),
        jnp.asarray(sizes), kc=12, tile_n=32,
        filter_bits=jnp.asarray(bits[np.maximum(probes, 0)]), interpret=True)
    got = tfk.fastscan_stream_topk_grouped(
        _t(table), _t(codes), _t(probes), _t(sizes), kc=12, tile_n=32,
        filter_bits=_t(bits))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("cap,tile_n", [(96, 0), (100, 0), (2048, 0),
                                        (64, 16), (64, 24)])
def test_tile_rules_match_reference(cap, tile_n):
    assert tops._stream_tile(cap, tile_n) == jops._stream_tile(cap, tile_n)
    for r in (1, 9, 40, 64, 200):
        assert tops._rerank_tile(r) == jops._rerank_tile(r)


def test_ops_stream_topk_equals_reference_ops():
    """Through the dispatch layer: keep > tile clamps kc the same way, and
    the in-place (nlist, W) bitmap equals the reference's pre-gather."""
    table, codes, probes, sizes, bits = _k1_inputs(
        11, g=6, nlist=4, cap=96, mh=4, fill=0.5)
    for keep in (3, 40):
        want = jops.fastscan_stream_topk(
            jnp.asarray(table), jnp.asarray(codes), jnp.asarray(probes),
            jnp.asarray(sizes), keep=keep, tile_n=32,
            filter_bits=jnp.asarray(bits))
        got = tops.fastscan_stream_topk(
            _t(table), _t(codes), _t(probes), _t(sizes), keep=keep,
            tile_n=32, filter_bits=_t(bits))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def assert_tie_aware(got_v, got_i, want_v, want_i, rtol=RTOL):
    """Values within rtol; ids equal up to reordering inside runs of values
    that are within rtol of each other."""
    got_v, want_v = np.asarray(got_v), np.asarray(want_v)
    got_i, want_i = np.asarray(got_i), np.asarray(want_i)
    np.testing.assert_allclose(got_v, want_v, rtol=rtol, atol=1e-6)
    for q in range(want_v.shape[0]):
        i, k = 0, want_v.shape[1]
        while i < k:
            j = i + 1
            while j < k and np.isclose(want_v[q, j], want_v[q, j - 1],
                                       rtol=rtol, atol=1e-6):
                j += 1
            assert sorted(got_i[q, i:j]) == sorted(want_i[q, i:j]), (q, i, j)
            i = j


def _k2_inputs(seed, *, n, d, q, r, integer, frac_invalid=0.2):
    rng = np.random.default_rng(seed)
    if integer:
        base = rng.integers(-4, 5, (n, d)).astype(np.float32)
        qv = rng.integers(-4, 5, (q, d)).astype(np.float32)
        base[1] = base[0]              # duplicate rows tie exactly
    else:
        base = rng.normal(size=(n, d)).astype(np.float32)
        qv = rng.normal(size=(q, d)).astype(np.float32)
    cand = rng.integers(0, n, (q, r)).astype(np.int32)
    cand[rng.random((q, r)) < frac_invalid] = -1
    cand[0, :3] = [0, 1, 0]            # duplicate ids and duplicate rows
    if q > 1:
        cand[1] = -1                   # a query with no candidate at all
    return base, qv, cand


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("r,tile,k", [(16, 8, 5), (24, 8, 10), (8, 8, 12)])
def test_k2_plain_matches_reference_kernel(integer, r, tile, k):
    base, qv, cand = _k2_inputs(r + k, n=300, d=16, q=5, r=r, integer=integer)
    norms = (base * base).sum(-1)
    xn = norms[np.maximum(cand, 0)]
    want_v, want_p = jrk.rerank_stream_topk(
        jnp.asarray(base), jnp.asarray(qv), jnp.asarray(cand),
        jnp.asarray(xn), k=k, tile_r=tile, interpret=True)
    got_v, got_p = trk.rerank_stream_topk(_t(base), _t(qv), _t(cand), _t(xn),
                                          k=k, tile_r=tile)
    if integer:
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
        np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
    else:
        assert_tie_aware(got_v, got_p, want_v, want_p)
    # k beyond the valid candidates: +inf / -1 tails agree
    np.testing.assert_array_equal(got_p.numpy()[1], -1)


@pytest.mark.parametrize("integer", [True, False])
def test_ops_rerank_pads_ragged_r_like_reference(integer):
    """R = 13 is not a tile multiple: both dispatch layers pad with -1."""
    base, qv, cand = _k2_inputs(7, n=200, d=8, q=4, r=13, integer=integer)
    norms = (base * base).sum(-1)
    want_v, want_i = jops.rerank_stream_topk(
        jnp.asarray(base), jnp.asarray(norms), jnp.asarray(qv),
        jnp.asarray(cand), k=6)
    got_v, got_i = tops.rerank_stream_topk(_t(base), _t(norms), _t(qv),
                                           _t(cand), k=6)
    if integer:
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    else:
        assert_tie_aware(got_v, got_i, want_v, want_i)


def _k1_torch(seed=0, **kw):
    table, codes, probes, sizes, bits = _k1_inputs(
        seed, g=4, nlist=3, cap=64, mh=4, fill=0.5, **kw)
    return _t(table), _t(codes), _t(probes), _t(sizes), _t(bits)


def test_k1_wrapper_rejects_what_the_kernel_does_not_take():
    table, codes, probes, sizes, bits = _k1_torch()
    call = tfk.fastscan_stream_topk_grouped
    with pytest.raises(ValueError, match="dtype|int32"):
        call(table, codes, probes.long(), sizes, kc=4, tile_n=32)
    with pytest.raises(ValueError, match="uint8"):
        call(table.int(), codes, probes, sizes, kc=4, tile_n=32)
    with pytest.raises(ValueError, match="contiguous"):
        call(table.transpose(1, 2).contiguous().transpose(1, 2), codes,
             probes, sizes, kc=4, tile_n=32)
    with pytest.raises(ValueError, match="contiguous"):
        call(table, codes, probes, sizes, kc=4, tile_n=32,
             filter_bits=torch.cat([bits, bits], 1)[:, ::2])
    with pytest.raises(ValueError, match="divide"):
        call(table, codes, probes, sizes, kc=4, tile_n=24)
    with pytest.raises(ValueError, match="kc"):
        call(table, codes, probes, sizes, kc=40, tile_n=32)
    with pytest.raises(ValueError, match="shared memory"):
        big = torch.zeros((1, 2**16, 4), dtype=torch.uint8)
        call(table[:1], big, probes[:1].clamp(max=0), sizes[:1], kc=4,
             tile_n=2**16)


def test_k1_smem_plan_accepts_every_tile_the_old_formula_did():
    """K1's shared-memory plan (sums, histogram, candidates, LUT) refuses no
    (tile_n, kc, M) that the sort-based plan's 8 * pow2(tile_n) + 16 * M
    accepted: the autotune sweep and the CPU wrappers rely on it."""
    def old(tile, m):
        return (1 << max(tile - 1, 0).bit_length()) * 8 + m * 16

    checked = 0
    for tile in (1, 3, 16, 100, 1000, 1024, 4096, 8192, 10000, 16384):
        for kc in {1, 40, 200, tile // 2 or 1, tile}:
            for m in (2, 6, 16, 32, 128, 1024, 6336, 10432, 14526):
                if kc <= tile and old(tile, m) <= tfk.SMEM_LIMIT:
                    checked += 1
                    assert tfk.smem_bytes(tile, kc, m) <= tfk.SMEM_LIMIT, (
                        tile, kc, m)
    assert checked > 300


def test_k6_smem_plan_accepts_every_tile_the_old_formula_did():
    """K6's shared-memory plan (a ring of LUT + code-chunk stages) refuses
    no (M, tile_n) that the wmma version's m * 256 + 8 * (256 + 1024)
    accepted (the plan does not depend on the tile), and the CPU wrapper
    takes those shapes; M = 1024 stays refused."""
    def old(m):
        return m * 256 + 8 * (256 + 1024)

    checked = 0
    for m in range(2, 1200, 2):
        if old(m) <= _build.SMEM_LIMIT:
            checked += 1
            assert tmk.smem_bytes(m) <= _build.SMEM_LIMIT, m
    assert checked == 434
    assert tmk.smem_bytes(1024) > _build.SMEM_LIMIT
    rng = np.random.default_rng(0)
    for m, tile in ((2, 8), (16, 1024), (128, 32), (868, 64)):
        table = torch.as_tensor(rng.integers(0, 256, (2, m, 16), np.uint8))
        codes = torch.as_tensor(rng.integers(0, 256, (2, 2 * tile, m // 2),
                                             np.uint8))
        got = tmk.fastscan_onehot_mxu_grouped(table, codes, tile_n=tile)
        assert got.shape == (2, 2 * tile)


def test_k2_smem_plan_accepts_every_shape_the_old_formula_did():
    """K2's shared memory (the running keys and a chunk's distances, each
    double-buffered) refuses no (D, tile_r, k) that the sort-based plan's
    8 * pow2(k + tile_r) + 4 * (D + tile_r + 4k) accepted, and the CPU
    wrapper takes those shapes."""
    def old(d, tile, k):
        return (1 << max(k + tile - 1, 0).bit_length()) * 8 + \
            (d + tile + 4 * k) * 4

    checked = 0
    for d in (1, 30, 128, 960, 4096, 20000, 50000):
        for tile in (1, 8, 16, 64, 100, 1024, 8192, 14600, 20000):
            for k in (1, 10, 64, 100, 1000, 8192, 14000):
                if old(d, tile, k) <= _build.SMEM_LIMIT:
                    checked += 1
                    assert trk.smem_bytes(d, tile, k) <= _build.SMEM_LIMIT, (
                        d, tile, k)
    assert checked > 200
    base, qv, cand = (_t(a) for a in _k2_inputs(0, n=50, d=8, q=2, r=16,
                                                 integer=True))
    vals, pos = trk.rerank_stream_topk(base, qv, cand, torch.zeros(cand.shape),
                                       k=3000, tile_r=16)
    assert vals.shape == pos.shape == (2, 3000)


def test_k5_smem_plan_accepts_every_m_the_old_formula_did():
    """K5's shared memory (a ring of LUT + code-chunk stages on the
    four-row path, the LUT alone at any other M) refuses no M that the
    register version's 16 * M accepted, and the CPU wrapper takes them."""
    checked = 0
    for m in range(2, 15000, 2):
        if 16 * m <= _build.SMEM_LIMIT:
            checked += 1
            assert tsk.smem_bytes(m) <= _build.SMEM_LIMIT, m
    assert checked == _build.SMEM_LIMIT // 32
    assert tsk.smem_bytes(14530) > _build.SMEM_LIMIT
    rng = np.random.default_rng(0)
    for m, tile in ((2, 8), (6, 10), (16, 1024), (32, 64), (128, 32),
                    (14528, 4)):
        table = torch.as_tensor(rng.integers(0, 256, (2, m, 16), np.uint8))
        codes = torch.as_tensor(rng.integers(0, 256, (2, 2 * tile, m // 2),
                                             np.uint8))
        got = tsk.fastscan_select_tree_grouped(table, codes, tile_n=tile)
        assert got.shape == (2, 2 * tile)


def test_k3_smem_plan_accepts_every_m_the_old_formula_did():
    """K3's shared memory (K5's plan: a ring of LUT + code-chunk stages on
    the four-row path, the LUT alone at any other M) refuses no M that the
    first version's 16 * M accepted (M <= 14,528), and the CPU wrapper
    takes them."""
    checked = 0
    for m in range(2, 15000, 2):
        if 16 * m <= _build.SMEM_LIMIT:
            checked += 1
            assert tsgk.smem_bytes(m) <= _build.SMEM_LIMIT, m
    assert checked == _build.SMEM_LIMIT // 32 == 7264
    assert tsgk.smem_bytes(14530) > _build.SMEM_LIMIT
    rng = np.random.default_rng(0)
    for m, cap, tile in ((2, 16, 8), (6, 37, 37), (16, 4096, 1024),
                         (32, 64, 64), (128, 32, 32), (14528, 4, 4)):
        table = torch.as_tensor(rng.integers(0, 256, (3, m, 16), np.uint8))
        store = torch.as_tensor(rng.integers(0, 256, (2, cap, m // 2),
                                             np.uint8))
        probes = torch.tensor([1, -1, 0], dtype=torch.int32)
        got = tsgk.fastscan_stream_grouped(table, store, probes, tile_n=tile)
        assert got.shape == (3, cap) and not got[1].any()
    with pytest.raises(ValueError, match="shared memory"):
        tsgk.fastscan_stream_grouped(
            torch.zeros((1, 14530, 16), dtype=torch.uint8),
            torch.zeros((1, 4, 7265), dtype=torch.uint8),
            torch.zeros(1, dtype=torch.int32), tile_n=4)


def test_k2_plain_equals_reference_on_ties_at_the_k_cut():
    """Repeated candidate ids on integer data: many positions share the
    k-th distance across several chunks; the plain twin keeps the
    reference's order (running entries, then earlier positions) bit for
    bit."""
    rng = np.random.default_rng(11)
    n, d, q, r, k, tile = 40, 16, 4, 48, 10, 8
    base = rng.integers(-2, 3, (n, d)).astype(np.float32)
    base[1] = base[0]
    qv = rng.integers(-2, 3, (q, d)).astype(np.float32)
    cand = rng.integers(0, 3, (q, r)).astype(np.int32)   # ids 0, 1, 2
    cand[rng.random((q, r)) < 0.2] = -1
    cand[1, 8:16] = -1                                   # a chunk of -1
    xn = ((base * base).sum(-1))[np.maximum(cand, 0)]
    want_v, want_p = jrk.rerank_stream_topk(
        jnp.asarray(base), jnp.asarray(qv), jnp.asarray(cand),
        jnp.asarray(xn), k=k, tile_r=tile, interpret=True)
    got_v, got_p = trk.rerank_stream_topk(_t(base), _t(qv), _t(cand), _t(xn),
                                          k=k, tile_r=tile)
    want_v, want_p = np.asarray(want_v), np.asarray(want_p)
    # every query's k-th value is shared by positions on both sides of the
    # cut, in more than one chunk (integer data: the distances are exact)
    dist = (qv * qv).sum(-1)[:, None] - 2 * np.einsum(
        "qd,qrd->qr", qv, base[np.maximum(cand, 0)]) + xn
    dist = np.where(cand >= 0, np.maximum(dist, 0), np.inf)
    for i in range(q):
        tied = np.flatnonzero(dist[i] == want_v[i, -1])
        assert np.isfinite(want_v[i, -1])
        assert len(set(tied) - set(want_p[i])) > 0
        assert len({p // tile for p in tied}) > 1
    np.testing.assert_array_equal(got_v.numpy(), want_v)
    np.testing.assert_array_equal(got_p.numpy(), want_p)


def test_k2_wrapper_rejects_what_the_kernel_does_not_take():
    base, qv, cand = (_t(a) for a in _k2_inputs(0, n=50, d=8, q=3, r=16,
                                                 integer=False))
    xn = torch.zeros(cand.shape)
    call = trk.rerank_stream_topk
    with pytest.raises(ValueError, match="float32"):
        call(base.double(), qv, cand, xn, k=4, tile_r=8)
    with pytest.raises(ValueError, match="int32"):
        call(base, qv, cand.long(), xn, k=4, tile_r=8)
    with pytest.raises(ValueError, match="contiguous"):
        call(base.T.contiguous().T, qv, cand, xn, k=4, tile_r=8)
    with pytest.raises(ValueError, match="tile_r"):
        call(base, qv, cand, xn, k=4, tile_r=5)


def test_cpu_calls_take_the_plain_version_and_count_no_launch():
    before = (tfk.launches, trk.launches)
    tfk.fastscan_stream_topk_grouped(*_k1_torch()[:4], kc=4, tile_n=32)
    base, qv, cand = (_t(a) for a in _k2_inputs(0, n=50, d=8, q=3, r=16,
                                                 integer=False))
    trk.rerank_stream_topk(base, qv, cand, torch.zeros(cand.shape), k=4,
                           tile_r=8)
    assert (tfk.launches, trk.launches) == before


def test_registries_hold_only_the_ported_impls():
    """Every impl of the reference is ported: the registries are equal."""
    for name in ("GROUPED_IMPLS", "IMPLS", "SCAN_IMPLS", "RERANK_CONCRETE",
                 "RERANK_IMPLS"):
        assert getattr(tops, name) == getattr(jops, name), name
    from repro_torch.engine import engine as teng
    assert teng.SCAN_IMPLS is tops.SCAN_IMPLS
    assert teng.RERANK_IMPLS is tops.RERANK_IMPLS
    for impl in ("simd", "gathered"):
        with pytest.raises(ValueError, match="unknown grouped impl"):
            tops.resolve_scan_impl(impl, 2, 32, 4, device="cpu")
    with pytest.raises(ValueError, match="unknown rerank impl"):
        tops.resolve_rerank_dispatch("ref", 2, 8, 4, 2, 10, device="cpu")


def test_build_key_covers_every_source():
    assert sorted(p.name for p in _build.CSRC.glob("*.cu")) == sorted(
        _build.SOURCES)
    assert sorted(p.name for p in _build.CSRC.glob("*.cuh")) == sorted(
        _build.HEADERS)
    assert len(_build.SOURCES) == 10
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert len(_build._digest()) == 16
    # every launcher the wrappers call has a ctypes signature
    for src in _build.SOURCES:
        text = (_build.CSRC / src).read_text()
        for fn in _build._SIGNATURES:
            if f'int {fn}(' in text:
                break
        else:
            raise AssertionError(f"{src} exports no bound launcher")
    # each shared-memory need the wrappers check is exported by a source
    text = "".join((_build.CSRC / src).read_text() for src in _build.SOURCES)
    for fn, nargs in _build.SMEM_FNS.items():
        sig = (rf"long long {fn}\(" + r"int \w+,\s*" * (nargs - 1)
               + r"int \w+\)")
        assert re.search(sig, text), fn

"""The port's flat fast-scan index and naive-PQ baseline (the paper's Fig. 2
pair) held against the JAX reference.

On the CPU the K7a/K7b/K7c wrappers run their plain PyTorch versions, which
must equal the Pallas kernels (run in interpret mode, as the reference's
own tests run them) bit for bit: the scans are integer sums, and the
block-min ids follow the same first-occurrence rule. Float stages (the
naive ADC sums, dequantized distances) agree within a stated f32
tolerance, ids tie-aware. ``tests/test_torch_cuda.py`` holds the CUDA
kernels to these plain versions on the card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fastscan as jfs
from repro.core import pq as jpq
from repro.data import vectors as jvec
from repro.kernels import ops as jops
from repro_torch import interop
from repro_torch.core import fastscan as tfs
from repro_torch.core import pq as tpq
from repro_torch.core import topk as ttopk
from repro_torch.core.metrics import recall_at_r
from repro_torch.data.vectors import make_sift_like
from repro_torch.kernels import blockmin_kernel as tbk
from repro_torch.kernels import mxu_flat_kernel as tmfk
from repro_torch.kernels import ops as tops
from repro_torch.kernels import select_flat_kernel as tsfk

RTOL = 1e-5


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return np.asarray(x)


def _case(seed, q, n, m, levels=256):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, levels, (q, m, 16), dtype=np.uint8),
            rng.integers(0, 256, (n, m // 2), dtype=np.uint8))


def _assert_tie_aware(gv, gi, wv, wi, tol):
    """Values within ``tol`` (per query); ids equal up to order inside
    runs of values within ``tol`` of each other."""
    gv, gi, wv, wi = (np.asarray(a) for a in (gv, gi, wv, wi))
    tol = np.broadcast_to(np.asarray(tol, np.float64).reshape(-1),
                          (wv.shape[0],))
    for q in range(wv.shape[0]):
        assert np.all(np.abs(gv[q] - wv[q]) <= tol[q]), q
        i = 0
        while i < wv.shape[1]:
            j = i + 1
            while j < wv.shape[1] and wv[q, j] - wv[q, j - 1] <= tol[q]:
                j += 1
            if j < wv.shape[1] or i == 0:
                assert sorted(gi[q, i:j]) == sorted(wi[q, i:j]), (q, i, j)
            i = j


# ---------------------------------------------------------------------------
# K7a / K7b through ops.fastscan_distances, K7c through ops.fastscan_blockmin
# ---------------------------------------------------------------------------

# tests/test_kernels.py SHAPES: minimal, ragged N, exact tile, ragged > 1
# tile, multi-tile wide M
SHAPES = [(1, 32, 2), (3, 100, 4), (8, 1024, 8), (2, 1500, 16),
          (5, 2048, 64)]


@pytest.mark.parametrize("impl", ["ref", "select", "mxu"])
@pytest.mark.parametrize("q,n,m", SHAPES)
def test_fastscan_distances_equal_reference(impl, q, n, m):
    table, codes = _case(q * 1000 + n + m, q, n, m)
    want = jops.fastscan_distances(jnp.asarray(table), jnp.asarray(codes),
                                   impl=impl, interpret=True)
    got = tops.fastscan_distances(_t(table), _t(codes), impl=impl)
    assert got.dtype == torch.int32 and got.shape == (q, n)
    np.testing.assert_array_equal(got.numpy(), _np(want))


def test_extreme_values_at_m128_stay_exact():
    """All-255 tables at M=128: 32640 per row, no overflow or clipping."""
    q, n, m = 2, 64, 128
    table = np.full((q, m, 16), 255, np.uint8)
    codes = np.random.default_rng(0).integers(0, 256, (n, m // 2), np.uint8)
    for impl in ("select", "mxu"):
        want = jops.fastscan_distances(jnp.asarray(table), jnp.asarray(codes),
                                       impl=impl, interpret=True)
        got = tops.fastscan_distances(_t(table), _t(codes), impl=impl)
        np.testing.assert_array_equal(got.numpy(), _np(want))
        assert int(got.max()) == int(got.min()) == 255 * m
    for got, want in zip(
            tops.fastscan_blockmin(_t(table), _t(codes), block=16),
            jops.fastscan_blockmin(jnp.asarray(table), jnp.asarray(codes),
                                   block=16, interpret=True)):
        np.testing.assert_array_equal(got.numpy(), _np(want))


@pytest.mark.parametrize("n", [3, 4097])
def test_select_all_255_at_m32_equals_reference(n):
    """All-255 LUTs at M=32, the widest M that K7a's register path takes on
    the card: 8,160 per row, held by its 16-bit lanes; N no multiple of 4."""
    q, m = 3, 32
    table = np.full((q, m, 16), 255, np.uint8)
    codes = np.random.default_rng(n).integers(0, 256, (n, m // 2), np.uint8)
    want = jops.fastscan_distances(jnp.asarray(table), jnp.asarray(codes),
                                   impl="select", interpret=True)
    got = tsfk.fastscan_select_tree(_t(table), _t(codes))
    np.testing.assert_array_equal(got.numpy(), _np(want))
    assert int(got.min()) == int(got.max()) == 255 * m


# (q, n, m, block, LUT levels): the reference's own cases, a {0, 1} LUT
# (ties everywhere: the first occurrence must win), block 100 on N=1500
# (a block that is no multiple of 8), ragged N
BLOCKMIN_CASES = [(3, 2048, 8, 1024, 256), (2, 1500, 4, 1024, 256),
                  (4, 3000, 8, 1000, 2), (3, 1500, 8, 100, 256),
                  (5, 1450, 6, 100, 2), (1, 40, 2, 8, 2)]


@pytest.mark.parametrize("q,n,m,block,levels", BLOCKMIN_CASES)
def test_fastscan_blockmin_equals_reference(q, n, m, block, levels):
    table, codes = _case(7 + n + block, q, n, m, levels)
    want = jops.fastscan_blockmin(jnp.asarray(table), jnp.asarray(codes),
                                  block=block, interpret=True)
    got = tops.fastscan_blockmin(_t(table), _t(codes), block=block)
    for a, b in zip(got, want):
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(a.numpy(), _np(b))


def test_blockmin_padded_row_wins_and_keeps_its_id_like_reference():
    """Codes are padded with 0xFF (code 15 everywhere); with LUT entry 15 at
    0 and no real nibble 15, the padded rows sum to 0 and win the ragged
    last block: both packages return an id >= N there."""
    rng = np.random.default_rng(3)
    table = rng.integers(1, 256, (3, 8, 16), np.uint8)
    table[:, :, 15] = 0
    codes = (rng.integers(0, 15, (1450, 4), np.uint8)
             | (rng.integers(0, 15, (1450, 4), np.uint8) << 4))
    want = jops.fastscan_blockmin(jnp.asarray(table), jnp.asarray(codes),
                                  block=100, interpret=True)
    got = tops.fastscan_blockmin(_t(table), _t(codes), block=100)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), _np(b))
    mins, ids = got
    assert mins.shape == (3, 15)
    assert bool((ids[:, -1] >= 1450).all()) and bool((mins[:, -1] == 0).all())
    assert bool((ids[:, :-1] < 1450).all())


def test_block_min_ref_takes_the_first_occurrence():
    """The plain version breaks ties by position explicitly (torch.min over
    a dim promises no order on the card)."""
    table = np.zeros((2, 4, 16), np.uint8)                # every sum is 0
    codes = np.random.default_rng(1).integers(0, 256, (60, 2), np.uint8)
    mins, ids = tbk.fastscan_blockmin_plain(_t(table), _t(codes), tile_n=20)
    assert bool((mins == 0).all())
    np.testing.assert_array_equal(ids.numpy(), [[0, 20, 40]] * 2)


# ---------------------------------------------------------------------------
# the naive-PQ baseline: decode, adc_lookup, search
# ---------------------------------------------------------------------------

def _codebook(seed, m=4, dsub=3, k=16):
    rng = np.random.default_rng(seed)
    return rng.normal(0, 1, (m, k, dsub)).astype(np.float32)


def test_decode_equals_reference_bitwise():
    cw = _codebook(0)
    codes = np.random.default_rng(1).integers(0, 16, (50, 4)).astype(np.int32)
    want = jpq.decode(jpq.PQCodebook(jnp.asarray(cw)), jnp.asarray(codes))
    got = tpq.decode(tpq.PQCodebook(_t(cw)), _t(codes))
    np.testing.assert_array_equal(got.numpy(), _np(want))


@pytest.mark.parametrize("batched", [False, True])
def test_adc_lookup_matches_reference(batched):
    rng = np.random.default_rng(2)
    table = rng.normal(0, 10, (5, 8, 16) if batched else (8, 16)
                       ).astype(np.float32)
    codes = rng.integers(0, 16, (300, 8)).astype(np.int32)
    want = _np(jpq.adc_lookup(jnp.asarray(table), jnp.asarray(codes)))
    got = tpq.adc_lookup(_t(table), _t(codes)).numpy()
    assert got.shape == want.shape
    # f32 sums of 8 terms in another order: well within 1e-5 of the scale
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=RTOL * np.abs(want).max())


@pytest.mark.parametrize("seed", range(3))
def test_naive_pq_search_matches_reference(seed):
    rng = np.random.default_rng(seed)
    cw = _codebook(seed, m=4, dsub=4)
    codes = rng.integers(0, 16, (500, 4)).astype(np.int32)
    codes[250:] = codes[:250]                  # every distance tied twice
    q = rng.normal(0, 1, (6, 16)).astype(np.float32)
    wv, wi = jpq.search(jpq.PQCodebook(jnp.asarray(cw)), jnp.asarray(codes),
                        jnp.asarray(q), topk=10)
    gv, gi = tpq.search(tpq.PQCodebook(_t(cw)), _t(codes), _t(q), topk=10)
    assert gi.dtype == torch.int32 and gv.shape == (6, 10)
    _assert_tie_aware(gv, gi, wv, wi, RTOL * np.abs(_np(wv)).max(axis=1))


@pytest.mark.parametrize("seed", range(4))
def test_smallest_k_keyed_keeps_lax_top_k_order(seed):
    """Tie-heavy rows, -0.0 beside +0.0 and infinities: smallest_k's keyed
    top-k returns exactly jax.lax.top_k(-x)'s ids, lowest index first."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-3, 4, (6, 200)).astype(np.float32) * 0.5
    zeros = x == 0
    x[zeros] = np.where(rng.random(zeros.sum()) < 0.5, -0.0, 0.0)
    x[0, :5] = np.inf
    x[1, :3] = -np.inf
    neg, want = jax.lax.top_k(-jnp.asarray(x), 25)
    got_v, got_i = ttopk.smallest_k(_t(x), 25)
    np.testing.assert_array_equal(got_i.numpy(), _np(want))
    np.testing.assert_array_equal(got_v.numpy(), -_np(neg))
    with pytest.raises(ValueError, match="exceeds"):
        ttopk.smallest_k(_t(x), 201)
    for dtype in (torch.float64, torch.int32):  # the keys hold f32 bits
        with pytest.raises(ValueError, match="float32"):
            ttopk.smallest_k(_t(x).to(dtype), 5)


# ---------------------------------------------------------------------------
# the flat index: a reference-built index through interop, the port's build
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sift_small():
    ds = make_sift_like(n=4000, nt=2000, nq=400, d=32, ncl=32, seed=3,
                        device="cpu")
    return ds


@pytest.fixture(scope="module")
def reference_index(sift_small):
    ds = sift_small
    return jfs.build_index(jax.random.PRNGKey(0), jnp.asarray(ds.train.numpy()),
                           jnp.asarray(ds.base.numpy()), m=8, iters=10)


def _arrays(jidx):
    return {"codewords": _np(jidx.codebook.codewords),
            "packed_codes": _np(jidx.packed_codes), "n": np.int64(jidx.n)}


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_reference_flat_index_searches_alike(sift_small, reference_index,
                                             metric):
    arrays = _arrays(reference_index)
    idx = interop.fastscan_index_from_arrays(arrays, device="cpu")
    back = interop.arrays_from_fastscan_index(idx)
    for key in arrays:
        np.testing.assert_array_equal(back[key], arrays[key])
    q = sift_small.queries[:40]
    jq = jnp.asarray(q.numpy())
    # the u8 tables of both packages: an entry that rounds the other way
    # (the f32 LUTs differ in the last bits) moves a sum by one step
    jl = jfs.quantize_lut(jpq.adc_table(reference_index.codebook, jq,
                                        metric=metric))
    tl = tfs.quantize_lut(tpq.adc_table(idx.codebook, q, metric=metric))
    flips = (tl.table_q8.numpy() != _np(jl.table_q8)).sum(axis=(1, 2))
    want = _np(jfs.compute_distances(reference_index, jq, impl="mxu",
                                     metric=metric))
    tol = RTOL * np.abs(want).max(axis=1) + flips * _np(jl.scale)
    for impl in ("ref", "select", "mxu"):
        got = tfs.compute_distances(idx, q, impl=impl, metric=metric).numpy()
        assert np.all(np.abs(got - want) <= tol[:, None]), impl
    wv, wi = jfs.search(reference_index, jq, topk=10, impl="mxu",
                        metric=metric)
    for impl in ("select", "mxu"):
        gv, gi = tfs.search(idx, q, topk=10, impl=impl, metric=metric)
        assert gi.dtype == torch.int32
        _assert_tie_aware(gv, gi, wv, wi, tol)


def test_port_build_index_holds_the_fig2_gap(sift_small, reference_index):
    """The port's own build (a torch.Generator, so not the reference's
    codebook) is held by recall: fast-scan within 0.05 of the naive PQ on
    the same codes (the paper's Fig. 2 parity), and within 0.05 of the
    reference build's fast-scan recall on the same data."""
    ds = sift_small
    idx = tfs.build_index(ds.train, ds.base, m=8, iters=10, seed=0,
                          device="cpu")
    assert idx.packed_codes.shape == (4000, 4) and idx.n == 4000
    _, fast = tfs.search(idx, ds.queries, topk=10, impl="mxu")
    _, sel = tfs.search(idx, ds.queries, topk=10, impl="select")
    assert torch.equal(fast, sel)
    _, naive = tpq.search(idx.codebook, tfs.unpack_codes(idx.packed_codes),
                          ds.queries, topk=10)
    _, ref_ids = jfs.search(reference_index, jnp.asarray(ds.queries.numpy()),
                            topk=10)
    r_fast = float(recall_at_r(fast, ds.gt_ids, 10))
    r_naive = float(recall_at_r(naive, ds.gt_ids, 10))
    r_ref = float(recall_at_r(_t(ref_ids), ds.gt_ids, 10))
    assert r_fast > 0.5
    assert abs(r_fast - r_naive) < 0.05, (r_fast, r_naive)
    assert abs(r_fast - r_ref) < 0.05, (r_fast, r_ref)


def test_generators_feed_both_packages_alike(sift_small):
    want = jvec.make_sift_like(n=4000, nt=2000, nq=400, d=32, ncl=32, seed=3)
    np.testing.assert_array_equal(sift_small.base.numpy(), _np(want.base))


# ---------------------------------------------------------------------------
# wrappers: input checks, and the CPU path launches nothing
# ---------------------------------------------------------------------------

def test_k7_wrappers_reject_what_the_kernels_do_not_take():
    table = torch.zeros((2, 8, 16), dtype=torch.uint8)
    codes = torch.zeros((64, 4), dtype=torch.uint8)
    with pytest.raises(ValueError, match="uint8"):
        tsfk.fastscan_select_tree(table.int(), codes)
    with pytest.raises(ValueError, match="2-D"):
        tmfk.fastscan_onehot_mxu(table, codes[None])
    with pytest.raises(ValueError, match="contiguous"):
        tsfk.fastscan_select_tree(table, torch.zeros((64, 8),
                                                     dtype=torch.uint8)[:, ::2])
    with pytest.raises(ValueError, match="does not match"):
        tmfk.fastscan_onehot_mxu(table, torch.zeros((64, 3),
                                                    dtype=torch.uint8))
    with pytest.raises(ValueError, match="does not match"):
        tsfk.fastscan_select_tree(torch.zeros((2, 8, 8), dtype=torch.uint8),
                                  codes)
    for tile in (0, 24):
        with pytest.raises(ValueError, match="divide"):
            tbk.fastscan_blockmin(table, codes, tile_n=tile)
    # K7c takes any block dividing N: no rule on N % 8
    mins, ids = tbk.fastscan_blockmin(table, torch.zeros((1500, 4),
                                                         dtype=torch.uint8),
                                      tile_n=100)
    assert mins.shape == ids.shape == (2, 15)
    with pytest.raises(ValueError, match="block=0"):
        tops.fastscan_blockmin(table, codes, block=0)
    with pytest.raises(ValueError, match="unknown impl"):
        tops.fastscan_distances(table, codes, impl="stream")
    with pytest.raises(ValueError, match="K=16"):
        tops.fastscan_distances(torch.zeros((2, 8, 4), dtype=torch.uint8),
                                codes)
    if not torch.cuda.is_available():       # entry points default to the card
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tfs.build_index(np.zeros((32, 8), np.float32),
                            np.zeros((8, 8), np.float32), m=4)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            interop.fastscan_index_from_arrays(
                {"codewords": np.zeros((4, 16, 2), np.float32),
                 "packed_codes": np.zeros((8, 2), np.uint8), "n": 8})


def test_cpu_calls_take_the_plain_versions_and_count_no_launch():
    table, codes = _case(11, 3, 200, 8)
    before = (tsfk.launches, tmfk.launches, tbk.launches)
    for impl in ("select", "mxu"):
        tops.fastscan_distances(_t(table), _t(codes), impl=impl)
    tops.fastscan_blockmin(_t(table), _t(codes), block=64)
    assert (tsfk.launches, tmfk.launches, tbk.launches) == before

"""The port's K3/K4/K5/K6 and margin pruning held against the JAX reference.

On the CPU each wrapper runs its plain PyTorch twin, which must equal the
Pallas kernel (run in interpret mode, as the reference's own tests run it)
bit for bit: the scans are integer sums, and K4's pruning decisions use the
same two-op f32 dequantization on both sides. ``tests/test_torch_cuda.py``
holds the CUDA kernels to these twins on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import topk as jtopk
from repro.kernels import fastscan_kernel as jfk
from repro.kernels import ops as jops
from repro_torch.core import topk as ttopk
from repro_torch.kernels import fastscan_kernel as tfk
from repro_torch.kernels import mxu_kernel as tmk
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import select_kernel as tsk
from repro_torch.kernels import stream_grouped_kernel as tsgk
from repro_torch.kernels import stream_prune_kernel as tspk


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return np.asarray(x)


def _bits(rng, nlist, cap, fill):
    mask = rng.random((nlist, cap)) < fill
    w = -(-cap // 8)
    padded = np.zeros((nlist, w * 8), bool)
    padded[:, :cap] = mask
    return np.packbits(padded.reshape(nlist, w, 8), axis=-1,
                       bitorder="little")[..., 0]


# ---------------------------------------------------------------------------
# K5 / K6: gathered grouped scans (and the 'ref' oracle)
# ---------------------------------------------------------------------------

# (g, cap, mh, tile): odd M/2, M=2, tile 8, a cap that is no tile multiple
GROUPED_GRID = [(1, 64, 4, 64), (3, 100, 4, 0), (4, 129, 3, 0),
                (2, 300, 1, 0), (5, 1024, 8, 0), (3, 200, 4, 64),
                (2, 40, 2, 8), (2, 64, 64, 0)]


@pytest.mark.parametrize("impl", ["ref", "select", "mxu", "stream"])
@pytest.mark.parametrize("g,cap,mh,tile", GROUPED_GRID)
def test_grouped_impls_equal_reference(impl, g, cap, mh, tile):
    rng = np.random.default_rng(g * 777 + cap + mh)
    table = rng.integers(0, 256, (g, 2 * mh, 16), np.uint8)
    codes = rng.integers(0, 256, (g, cap, mh), np.uint8)
    want = _np(jops.fastscan_grouped(jnp.asarray(table), jnp.asarray(codes),
                                     impl=impl, tile_n=tile))
    got = tops.fastscan_grouped(_t(table), _t(codes), impl=impl, tile_n=tile)
    assert got.dtype == torch.int32 and got.shape == (g, cap)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("which", ["select", "mxu"])
@pytest.mark.parametrize("g,n,mh,tile", [(3, 64, 4, 32), (2, 16, 3, 8),
                                         (4, 96, 1, 32), (2, 128, 8, 128)])
def test_k5_k6_twins_equal_reference_kernels(which, g, n, mh, tile):
    """Kernel level: the padded gathered copy straight into the Pallas
    kernel and into the port's wrapper."""
    rng = np.random.default_rng(n + mh)
    table = rng.integers(0, 256, (g, 2 * mh, 16), np.uint8)
    codes = rng.integers(0, 256, (g, n, mh), np.uint8)
    codes[0, : n // 2] = 0                       # an all-zero (padded) run
    jfn = (jfk.fastscan_select_tree_grouped if which == "select"
           else jfk.fastscan_onehot_mxu_grouped)
    tfn = (tsk.fastscan_select_tree_grouped if which == "select"
           else tmk.fastscan_onehot_mxu_grouped)
    want = jfn(jnp.asarray(table), jnp.asarray(codes), tile_n=tile,
               interpret=True)
    got = tfn(_t(table), _t(codes), tile_n=tile)
    np.testing.assert_array_equal(got.numpy(), _np(want))


def test_grouped_extreme_values_stay_exact():
    """All-255 tables at M=128: the s32 sums reach 255*M exactly."""
    g, cap, m = 2, 64, 128
    table = np.full((g, m, 16), 255, np.uint8)
    codes = np.random.default_rng(4).integers(0, 256, (g, cap, m // 2),
                                              np.uint8)
    for impl in ("select", "mxu", "ref"):
        got = tops.fastscan_grouped(_t(table), _t(codes), impl=impl)
        assert int(got.max()) == int(got.min()) == 255 * m


def test_ref_oracles_equal_reference():
    from repro.kernels import ref as jref
    rng = np.random.default_rng(5)
    table = rng.integers(0, 256, (3, 6, 16), np.uint8)
    codes = rng.integers(0, 256, (64, 3), np.uint8)
    np.testing.assert_array_equal(tref.unpack_nibbles(_t(codes)).numpy(),
                                  _np(jref.unpack_nibbles(jnp.asarray(codes))))
    np.testing.assert_array_equal(
        tref.fastscan_distances_ref(_t(table), _t(codes)).numpy(),
        _np(jref.fastscan_distances_ref(jnp.asarray(table),
                                        jnp.asarray(codes))))
    codes[5] = codes[40]            # equal minima: first occurrence wins
    for got, want in zip(
            tref.fastscan_block_min_ref(_t(table), _t(codes), 16),
            jref.fastscan_block_min_ref(jnp.asarray(table),
                                        jnp.asarray(codes), 16)):
        np.testing.assert_array_equal(got.numpy(), _np(want))


def test_ref_chunks_over_groups_without_changing_sums(monkeypatch):
    rng = np.random.default_rng(6)
    table = _t(rng.integers(0, 256, (7, 4, 16), np.uint8))
    codes = _t(rng.integers(0, 256, (7, 33, 2), np.uint8))
    whole = tref.fastscan_grouped_ref(table, codes)
    monkeypatch.setattr(tref, "_CHUNK_ELEMS", 33 * 4 * 2)   # 2 groups a chunk
    torch.testing.assert_close(tref.fastscan_grouped_ref(table, codes), whole,
                               rtol=0, atol=0)


# ---------------------------------------------------------------------------
# K3: the in-place grouped scan
# ---------------------------------------------------------------------------

# (g, nlist, cap, mh, tile): lists of 96 x 3 and 40 x 1 bytes, and an odd
# cap read whole (37 x 3: no list but the first 4-byte aligned, no output
# row but the first 16-byte aligned), the four-row widths M/2 = 2, 6, 12
# and 16, and M/2 = 5 and 64 off the four-row set
STREAM_GRID = [(4, 3, 64, 4, 16), (5, 4, 96, 3, 32), (3, 2, 40, 1, 8),
               (6, 5, 128, 8, 128), (2, 3, 100, 4, 100), (4, 3, 37, 3, 37),
               (3, 2, 24, 2, 8), (3, 3, 40, 6, 20), (2, 2, 16, 12, 16),
               (3, 2, 32, 16, 8), (3, 2, 30, 5, 10), (2, 2, 16, 64, 8)]


@pytest.mark.parametrize("g,nlist,cap,mh,tile", STREAM_GRID)
def test_k3_twin_equals_reference_kernel(g, nlist, cap, mh, tile):
    rng = np.random.default_rng(g + cap)
    table = rng.integers(0, 256, (g, 2 * mh, 16), np.uint8)
    codes = rng.integers(0, 256, (nlist, cap, mh), np.uint8)
    probes = rng.integers(-1, nlist, g).astype(np.int32)
    probes[0] = -1                                  # zeros, nothing read
    want = jfk.fastscan_stream_grouped(jnp.asarray(table), jnp.asarray(codes),
                                       jnp.asarray(probes), tile_n=tile,
                                       interpret=True)
    got = tsgk.fastscan_stream_grouped(_t(table), _t(codes), _t(probes),
                                       tile_n=tile)
    np.testing.assert_array_equal(got.numpy(), _np(want))
    assert not got[0].any()
    # through the dispatch layer's tile rule
    np.testing.assert_array_equal(
        tops.fastscan_stream_grouped(_t(table), _t(codes), _t(probes)).numpy(),
        _np(jops.fastscan_stream_grouped(jnp.asarray(table),
                                         jnp.asarray(codes),
                                         jnp.asarray(probes))))


# ---------------------------------------------------------------------------
# K4: early exit
# ---------------------------------------------------------------------------

def _ee_inputs(seed, *, nlist, cap, mh, q, p, occupancy, skew, fill=None):
    """Random LUTs with a per-group affine; ``skew`` pushes half of each
    query's groups' biases far up so their bounds lose to the running
    threshold and tiles are skipped."""
    rng = np.random.default_rng(seed)
    g = q * p
    table = rng.integers(0, 256, (g, 2 * mh, 16), np.uint8)
    codes = rng.integers(0, 256, (nlist, cap, mh), np.uint8)
    sizes = (np.full(nlist, cap) if occupancy == "full"
             else rng.integers(0, cap + 1, nlist)).astype(np.int32)
    probes = np.where(rng.random((q, p)) < 0.8, rng.integers(0, nlist, (q, p)),
                      -1).astype(np.int32)
    if q > 1:
        probes[1] = -1                      # a query with no valid probe
    scales = rng.uniform(0.5, 2.0, g).astype(np.float32)
    biases = rng.uniform(0.0, 50.0, g).astype(np.float32)
    if skew:
        biases.reshape(q, p)[:, p // 2:] += np.float32(1e5)
    bits = None if fill is None else _bits(rng, nlist, cap, fill)
    return table, codes, probes.reshape(-1), sizes, scales, biases, bits


def _ee_both(table, codes, probes, sizes, scales, biases, bits, *, keep,
             tile, p):
    kw = dict(keep=keep, tile_n=tile, early_exit=True, groups_per_query=p)
    want = jops.fastscan_stream_topk(
        jnp.asarray(table), jnp.asarray(codes), jnp.asarray(probes),
        jnp.asarray(sizes), filter_bits=None if bits is None
        else jnp.asarray(bits), scales=jnp.asarray(scales),
        biases=jnp.asarray(biases), interpret=True, **kw)
    got = tops.fastscan_stream_topk(
        _t(table), _t(codes), _t(probes), _t(sizes),
        filter_bits=None if bits is None else _t(bits), scales=_t(scales),
        biases=_t(biases), **kw)
    assert len(got) == len(want) == 3
    for name, a, b in zip(("vals", "slots", "skipped"), got, want):
        np.testing.assert_array_equal(a.numpy(), _np(b), err_msg=name)
    return got


# the reference's EE_GRID: (nlist, cap, m, tile_n, keep, p, occupancy)
EE_GRID = [
    (6, 64, 4, 32, 8, 3, "ragged"),
    (6, 64, 4, 64, 8, 3, "full"),
    (4, 100, 8, 32, 5, 4, "ragged"),
    (8, 48, 4, 16, 16, 2, "ragged"),
    (5, 32, 2, 8, 1, 5, "full"),
    (3, 64, 4, 16, 32, 3, "full"),     # keep > tile: pruning disarmed
]


@pytest.mark.parametrize("skew", [False, True])
@pytest.mark.parametrize("nlist,cap,m,tile,keep,p,occ", EE_GRID)
def test_k4_equals_reference_over_ee_grid(nlist, cap, m, tile, keep, p, occ,
                                          skew):
    args = _ee_inputs(nlist * 7 + cap + keep, nlist=nlist, cap=cap,
                      mh=m // 2, q=3, p=p, occupancy=occ, skew=skew)
    _, _, skipped = _ee_both(*args, keep=keep, tile=tile, p=p)
    assert not skipped.reshape(3, -1)[1].any()   # no valid probe, no skip
    if keep > tile:
        assert not skipped.any()


def test_k4_skips_fire_on_skewed_data():
    args = _ee_inputs(11, nlist=8, cap=64, mh=4, q=2, p=8, occupancy="full",
                      skew=True)
    probes = np.tile(np.arange(8, dtype=np.int32), 2)   # every list, twice
    args = (args[0], args[1], probes) + args[3:]
    _, _, skipped = _ee_both(*args, keep=4, tile=16, p=8)
    assert skipped.sum() > 0


@pytest.mark.parametrize("fill", [0.0, 0.5, 1.0])
def test_k4_equals_reference_with_filters(fill):
    args = _ee_inputs(21, nlist=6, cap=64, mh=2, q=2, p=6, occupancy="full",
                      skew=True, fill=fill)
    _ee_both(*args, keep=6, tile=16, p=6)


def test_k4_twin_at_kernel_level_and_ties():
    """Tie-heavy sums (tiny LUT values, few codes) through the kernel-level
    entry, bounds computed the reference's way."""
    rng = np.random.default_rng(3)
    g, nlist, cap, mh, tile, kc, gpq = 6, 4, 64, 2, 16, 5, 3
    table = rng.integers(0, 2, (g, 2 * mh, 16), np.uint8)
    codes = rng.integers(0, 3, (nlist, cap, mh), np.uint8)
    probes = rng.integers(0, nlist, g).astype(np.int32)
    sizes = rng.integers(cap // 2, cap + 1, nlist).astype(np.int32)
    scales = np.full(g, 0.25, np.float32)
    biases = np.linspace(0, 3, g).astype(np.float32)
    acc_min = table.astype(np.int32).min(-1).sum(-1)
    bounds = scales * acc_min.astype(np.float32) + biases
    want = jfk.fastscan_stream_topk_grouped(
        jnp.asarray(table), jnp.asarray(codes), jnp.asarray(probes),
        jnp.asarray(sizes), kc=kc, tile_n=tile, interpret=True,
        early_exit=True, groups_per_query=gpq, scales=jnp.asarray(scales),
        biases=jnp.asarray(biases))
    got = tspk.fastscan_stream_topk_prune(
        _t(table), _t(codes), _t(probes), _t(sizes), _t(bounds), _t(scales),
        _t(biases), kc=kc, tile_n=tile, groups_per_query=gpq)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), _np(b))


@pytest.mark.parametrize("fill", [None, 0.5])
def test_k4_ties_at_the_kc_cut_equal_reference(fill):
    """A {0, 1} LUT: most sums tie, so many rows share the kc-th value
    across the cut and the lowest slots must win, as the reference's sort
    keeps them; skewed biases make tiles skip. vals, slots and skipped bit
    for bit."""
    args = _ee_inputs(41, nlist=6, cap=64, mh=4, q=3, p=6,
                      occupancy="ragged", skew=True, fill=fill)
    table = args[0] & 1
    _, _, skipped = _ee_both(table, *args[1:], keep=8, tile=32, p=6)
    assert skipped.sum() > 0


@pytest.mark.parametrize("fill", [None, 0.5])
def test_k1_ties_at_the_kc_cut_equal_reference(fill):
    """K1 (no early exit) on a {0, 1} LUT over 128-row tiles: sums lie in
    [0, 8], so dozens of rows share the kc-th value and the lowest slots
    must win the cut, as the reference's sort keeps them. Lists of every
    occupancy, one with fewer than kc rows. vals and slots bit for bit."""
    rng = np.random.default_rng(51)
    g, nlist, cap, mh, tile, kc = 8, 5, 256, 4, 128, 40
    table = rng.integers(0, 2, (g, 2 * mh, 16), np.uint8)
    codes = rng.integers(0, 256, (nlist, cap, mh), np.uint8)
    sizes = np.array([cap, 200, 129, kc // 2, 0], np.int32)
    probes = np.array([0, 1, 2, 3, 4, -1, 0, 2], np.int32)
    bits = None if fill is None else _bits(rng, nlist, cap, fill)
    want = jfk.fastscan_stream_topk_grouped(
        jnp.asarray(table), jnp.asarray(codes), jnp.asarray(probes),
        jnp.asarray(sizes), kc=kc, tile_n=tile, interpret=True,
        filter_bits=None if bits is None
        else jnp.asarray(bits[np.maximum(probes, 0)]))
    got = tfk.fastscan_stream_topk_grouped(
        _t(table), _t(codes), _t(probes), _t(sizes), kc=kc, tile_n=tile,
        filter_bits=None if bits is None else _t(bits))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), _np(b))
    # the cut falls inside a run of equal values
    vals = got[0].numpy()
    assert (vals[:, :, -1] == vals[:, :, -2]).any()


def test_disarmed_early_exit_is_k1_with_zero_skips():
    args = _ee_inputs(31, nlist=4, cap=64, mh=2, q=2, p=3, occupancy="full",
                      skew=True)
    table, codes, probes, sizes, scales, biases, _ = args
    vals, slots, skipped = tops.fastscan_stream_topk(
        _t(table), _t(codes), _t(probes), _t(sizes), keep=40, tile_n=16,
        early_exit=True, groups_per_query=3, scales=_t(scales),
        biases=_t(biases))
    k1 = tops.fastscan_stream_topk(_t(table), _t(codes), _t(probes),
                                   _t(sizes), keep=40, tile_n=16)
    assert torch.equal(vals, k1[0]) and torch.equal(slots, k1[1])
    assert not skipped.any()
    with pytest.raises(ValueError, match="affine"):
        tops.fastscan_stream_topk(_t(table), _t(codes), _t(probes),
                                  _t(sizes), keep=4, early_exit=True,
                                  groups_per_query=3)


# ---------------------------------------------------------------------------
# wrappers: input checks, and the CPU path launches nothing
# ---------------------------------------------------------------------------

def test_new_wrappers_reject_what_the_kernels_do_not_take():
    rng = np.random.default_rng(0)
    table = _t(rng.integers(0, 256, (4, 8, 16), np.uint8))
    codes = _t(rng.integers(0, 256, (4, 64, 4), np.uint8))
    store = _t(rng.integers(0, 256, (3, 64, 4), np.uint8))
    probes = _t(np.array([0, 1, 2, -1], np.int32))
    sizes = _t(np.array([64, 10, 0], np.int32))
    f32 = torch.ones(4)
    with pytest.raises(ValueError, match="divide"):
        tsk.fastscan_select_tree_grouped(table, codes, tile_n=24)
    with pytest.raises(ValueError, match="uint8"):
        tmk.fastscan_onehot_mxu_grouped(table.int(), codes, tile_n=16)
    with pytest.raises(ValueError, match="shared memory"):
        big = torch.zeros((1, 1024, 16), dtype=torch.uint8)
        tmk.fastscan_onehot_mxu_grouped(big, torch.zeros((1, 16, 512),
                                                         dtype=torch.uint8),
                                        tile_n=16)
    with pytest.raises(ValueError, match="int32"):
        tsgk.fastscan_stream_grouped(table, store, probes.long(), tile_n=16)
    with pytest.raises(ValueError, match="contiguous"):
        tsgk.fastscan_stream_grouped(table, store[:, ::2], probes, tile_n=16)
    with pytest.raises(ValueError, match="groups_per_query"):
        tspk.fastscan_stream_topk_prune(table, store, probes, sizes, f32, f32,
                                        f32, kc=4, tile_n=16,
                                        groups_per_query=3)
    with pytest.raises(ValueError, match="float32"):
        tspk.fastscan_stream_topk_prune(table, store, probes, sizes,
                                        f32.double(), f32, f32, kc=4,
                                        tile_n=16, groups_per_query=2)


def test_cpu_calls_take_the_plain_versions_and_count_no_launch():
    rng = np.random.default_rng(1)
    table = _t(rng.integers(0, 256, (4, 8, 16), np.uint8))
    codes = _t(rng.integers(0, 256, (4, 64, 4), np.uint8))
    before = (tsgk.launches, tspk.launches, tsk.launches, tmk.launches)
    for impl in ("select", "mxu", "stream"):
        tops.fastscan_grouped(table, codes, impl=impl)
    probes = _t(np.arange(4, dtype=np.int32))
    tops.fastscan_stream_topk(table, codes, probes,
                              _t(np.full(4, 64, np.int32)), keep=4,
                              early_exit=True, groups_per_query=2,
                              scales=torch.ones(4), biases=torch.zeros(4))
    assert (tsgk.launches, tspk.launches, tsk.launches,
            tmk.launches) == before


# ---------------------------------------------------------------------------
# margin_prune_probes
# ---------------------------------------------------------------------------

def _margin_case(seed, q=4, p=8):
    rng = np.random.default_rng(seed)
    vals = (rng.random((q, p)) * 10).astype(np.float32)
    probes = np.where(rng.random((q, p)) < 0.8, rng.integers(0, 64, (q, p)),
                      -1).astype(np.int32)
    vals[probes < 0] = np.inf
    vals[0, 1] = vals[0, 0]               # a tie with the best
    return vals, probes


@pytest.mark.parametrize("tau", [0.0, 0.05, 0.3, 1.0, 4.0, np.inf])
@pytest.mark.parametrize("seed", range(4))
def test_margin_prune_probes_equals_reference(seed, tau):
    vals, probes = _margin_case(seed)
    want = jtopk.margin_prune_probes(jnp.asarray(vals), jnp.asarray(probes),
                                     tau)
    got = ttopk.margin_prune_probes(_t(vals), _t(probes), tau)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), _np(b))
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.int32


def test_margin_prune_probes_per_query_tau_absent_rows_and_zero_best():
    vals, probes = _margin_case(9)
    probes[2] = -1                        # a row with every probe absent
    vals[2] = np.inf
    vals[3, 0] = 0.0                      # d0 == 0 with tau = inf: no NaN
    taus = np.array([0.0, 0.2, 1.0, np.inf], np.float32)
    want = jtopk.margin_prune_probes(jnp.asarray(vals), jnp.asarray(probes),
                                     jnp.asarray(taus))
    got = ttopk.margin_prune_probes(_t(vals), _t(probes), _t(taus))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), _np(b))
    assert (got[0][2] == -1).all() and int(got[1][2]) == 0
    np.testing.assert_array_equal(got[0][3].numpy(), probes[3])

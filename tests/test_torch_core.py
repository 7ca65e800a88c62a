"""The port's core numerics held against the JAX reference on the CPU.

Inputs are made with numpy from a seed and handed to both packages.
Integer stages (u8 tables, packing, list layout, selection order) must be
equal; float stages agree within a stated f32 tolerance, since the two
frameworks reduce in different orders.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fastscan as jfs
from repro.core import kmeans as jkm
from repro.core import lists as jlists
from repro.core import metrics as jmetrics
from repro.core import pq as jpq
from repro.core import topk as jtopk
from repro.data import vectors as jvec
from repro_torch.core import fastscan as tfs
from repro_torch.core import kmeans as tkm
from repro_torch.core import lists as tlists
from repro_torch.core import metrics as tmetrics
from repro_torch.core import pq as tpq
from repro_torch.core import topk as ttopk
from repro_torch.data import vectors as tvec

# cross-framework f32 tolerance: same expression, different reduction order
RTOL = 1e-5


def _t(x):
    return torch.from_numpy(np.array(x))


def test_pairwise_sqdist_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(40, 16)).astype(np.float32)
    c = rng.normal(size=(12, 16)).astype(np.float32)
    want = np.asarray(jkm.pairwise_sqdist(jnp.asarray(x), jnp.asarray(c)))
    got = tkm.pairwise_sqdist(_t(x), _t(c)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-5)
    assert (got >= 0).all()


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_adc_table_matches_reference(metric):
    rng = np.random.default_rng(1)
    cw = rng.normal(size=(4, 16, 8)).astype(np.float32)
    q = rng.normal(size=(5, 32)).astype(np.float32)
    want = np.asarray(jpq.adc_table(jpq.PQCodebook(jnp.asarray(cw)),
                                    jnp.asarray(q), metric=metric))
    got = tpq.adc_table(tpq.PQCodebook(_t(cw)), _t(q), metric=metric).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-5)


def test_encode_matches_reference():
    rng = np.random.default_rng(2)
    cw = rng.normal(size=(4, 16, 8)).astype(np.float32)
    x = rng.normal(size=(64, 32)).astype(np.float32)
    want = np.asarray(jpq.encode(jpq.PQCodebook(jnp.asarray(cw)),
                                 jnp.asarray(x)))
    got = tpq.encode(tpq.PQCodebook(_t(cw)), _t(x)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_lut_matches_reference(seed):
    """Same f32 table in: u8 tables equal, scale and bias equal to within
    an ulp-level rtol."""
    rng = np.random.default_rng(seed)
    table = (rng.gamma(2.0, 3.0, size=(6, 8, 16))
             * rng.uniform(0.1, 10, size=(6, 1, 1))).astype(np.float32)
    want = jfs.quantize_lut(jnp.asarray(table))
    got = tfs.quantize_lut(_t(table))
    np.testing.assert_array_equal(got.table_q8.numpy(),
                                  np.asarray(want.table_q8))
    np.testing.assert_allclose(got.scale.numpy(), np.asarray(want.scale),
                               rtol=2e-7)
    np.testing.assert_allclose(got.bias.numpy(), np.asarray(want.bias),
                               rtol=2e-7)
    acc = rng.integers(0, 255 * 8, size=(6, 20)).astype(np.int32)
    np.testing.assert_allclose(
        tfs.dequantize_acc(got, _t(acc)).numpy(),
        np.asarray(jfs.dequantize_acc(want, jnp.asarray(acc))), rtol=RTOL)


def test_quantize_lut_constant_table_uses_floor_scale():
    table = np.full((2, 4, 16), 3.5, np.float32)
    got = tfs.quantize_lut(_t(table))
    want = jfs.quantize_lut(jnp.asarray(table))
    np.testing.assert_array_equal(got.table_q8.numpy(),
                                  np.asarray(want.table_q8))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))


@pytest.mark.parametrize("m", [2, 6, 16])
def test_pack_unpack_codes_match_reference(m):
    rng = np.random.default_rng(m)
    codes = rng.integers(0, 16, size=(33, m)).astype(np.int32)
    want = np.asarray(jfs.pack_codes(jnp.asarray(codes)))
    got = tfs.pack_codes(_t(codes))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tfs.unpack_codes(got).numpy(), codes)


@pytest.mark.parametrize("cap", [8, 13, 64])
def test_filter_pack_unpack_match_reference(cap):
    rng = np.random.default_rng(cap)
    mask = rng.random((5, cap)) < 0.5
    want = np.asarray(jlists.pack_filter_mask(jnp.asarray(mask)))
    got = tlists.pack_filter_mask(_t(mask))
    assert got.dtype == torch.uint8
    assert got.shape[-1] == tlists.filter_words(cap) == jlists.filter_words(cap)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tlists.unpack_filter_mask(got, cap).numpy(),
                                  mask)


def _random_assign(seed, n=300, nlist=7):
    rng = np.random.default_rng(seed)
    assign = rng.integers(0, nlist, n)
    assign[assign == 3] = 4          # one empty list
    packed = rng.integers(0, 256, (n, 4), dtype=np.uint8)
    ids = rng.permutation(10 * n)[:n].astype(np.int32)
    attrs = rng.integers(0, 5, n).astype(np.int32)
    return assign, packed, ids, attrs


@pytest.mark.parametrize("cap", [None, 20, 64])
def test_build_lists_layout_matches_reference(cap):
    """Byte-for-byte layout, including overflow past cap, empty lists,
    custom ids and attrs."""
    assign, packed, ids, attrs = _random_assign(4)
    want = jlists.store_arrays(jlists.build_lists(
        assign, packed, nlist=7, cap=cap, ids=ids, attrs=attrs))
    got = tlists.store_arrays(tlists.build_lists(
        assign, packed, nlist=7, cap=cap, ids=ids, attrs=attrs, device="cpu"))
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_filter_pass_sizes_and_probe_helpers_match_reference():
    assign, packed, ids, attrs = _random_assign(5)
    jstore = jlists.build_lists(assign, packed, nlist=7, attrs=attrs)
    tstore = tlists.store_from_arrays(jlists.store_arrays(jstore),
                                      device="cpu")
    rng = np.random.default_rng(6)
    mask = rng.random((7, tstore.cap)) < 0.5
    bits = np.asarray(jlists.pack_filter_mask(jnp.asarray(mask)))
    np.testing.assert_array_equal(
        tlists.filter_pass_sizes(tstore, _t(bits)).numpy(),
        np.asarray(jlists.filter_pass_sizes(jstore, jnp.asarray(bits))))
    probes = np.array([[0, 3, -1], [6, 6, 2]], np.int32)
    np.testing.assert_array_equal(
        tstore.gather_ids(_t(probes)).numpy(),
        np.asarray(jstore.gather_ids(jnp.asarray(probes))))
    np.testing.assert_array_equal(
        tstore.probed_sizes(_t(probes)).numpy(),
        np.asarray(jstore.probed_sizes(jnp.asarray(probes))))
    np.testing.assert_array_equal(
        tlists.base_norms(_t(np.arange(12, dtype=np.float32).reshape(3, 4))
                          ).numpy(), [14.0, 126.0, 366.0])


@pytest.mark.parametrize("new_cap", [20, 33, 64])
def test_grow_cap_matches_reference(new_cap):
    assign, packed, ids, attrs = _random_assign(8)
    jstore = jlists.build_lists(assign, packed, nlist=7, cap=20, ids=ids,
                                attrs=attrs)
    want = jlists.store_arrays(jlists.grow_cap(jstore, new_cap))
    got = tlists.store_arrays(tlists.grow_cap(
        tlists.store_from_arrays(jlists.store_arrays(jstore), device="cpu"),
        new_cap))
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    with pytest.raises(ValueError, match="grow_cap"):
        tlists.grow_cap(tlists.store_from_arrays(want, device="cpu"),
                        new_cap - 1)


def test_list_store_shape_properties_hold_for_stacked_stores():
    """nlist/cap read the trailing dims, so a shard-stacked (S, nlist, cap)
    store reports the per-shard list count and capacity."""
    assign, packed, _, _ = _random_assign(7)
    one = tlists.build_lists(assign, packed, nlist=7, cap=50, device="cpu")
    stacked = tlists.ListStore(*(torch.stack([t, t, t]) for t in one[:3]))
    assert stacked.ids.shape == (3, 7, 50)
    assert (stacked.nlist, stacked.cap) == (one.nlist, one.cap) == (7, 50)
    bits = tlists.pack_filter_mask(torch.ones(3, 7, 50, dtype=torch.bool))
    np.testing.assert_array_equal(
        tlists.filter_pass_sizes(stacked, bits).numpy(),
        np.stack([one.sizes.numpy()] * 3))


def _tie_heavy(seed, shape=(6, 50), levels=4):
    return np.random.default_rng(seed).integers(0, levels, shape).astype(
        np.float32)


@pytest.mark.parametrize("seed", range(6))
def test_smallest_k_keeps_lax_top_k_tie_order(seed):
    d = _tie_heavy(seed)
    for k in (1, 7, 50):
        wv, wi = jtopk.smallest_k(jnp.asarray(d), k)
        gv, gi = ttopk.smallest_k(_t(d), k)
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        assert gi.dtype == torch.int32


@pytest.mark.parametrize("seed", range(4))
def test_masked_topk_and_gather_ids_match_reference(seed):
    rng = np.random.default_rng(100 + seed)
    d = _tie_heavy(seed, (5, 30))
    valid = rng.random((5, 30)) < 0.3
    ids = rng.permutation(1000)[:150].reshape(5, 30).astype(np.int32)
    wv, wp = jtopk.masked_topk(jnp.asarray(d), jnp.asarray(valid), 12)
    gv, gp = ttopk.masked_topk(_t(d), _t(valid), 12)
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))
    np.testing.assert_array_equal(
        ttopk.gather_ids(_t(ids), gp).numpy(),
        np.asarray(jtopk.gather_ids(jnp.asarray(ids), wp)))


def test_generators_and_ground_truth_match_reference():
    want = jvec.make_sift_like(n=600, nt=200, nq=6, d=16, ncl=8, seed=9)
    got = tvec.make_sift_like(n=600, nt=200, nq=6, d=16, ncl=8, seed=9,
                              device="cpu")
    for a, b in ((got.base, want.base), (got.train, want.train),
                 (got.queries, want.queries)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(got.gt_ids[:, 0].numpy(),
                                  np.asarray(want.gt_ids)[:, 0])
    deep = tvec.make_deep_like(n=300, nt=50, nq=4, d=12, ncl=4, device="cpu")
    np.testing.assert_array_equal(
        deep.base.numpy(),
        np.asarray(jvec.make_deep_like(n=300, nt=50, nq=4, d=12, ncl=4).base))


def test_recall_at_r_matches_reference():
    rng = np.random.default_rng(3)
    pred = rng.integers(0, 20, (16, 10)).astype(np.int32)
    gt = rng.integers(0, 20, (16, 5)).astype(np.int32)
    for r in (None, 1, 5):
        assert float(tmetrics.recall_at_r(_t(pred), _t(gt), r)) == pytest.approx(
            float(jmetrics.recall_at_r(jnp.asarray(pred), jnp.asarray(gt), r)))


@pytest.mark.parametrize("seed", [0, 1])
def test_intersection_recall_matches_reference(seed):
    """The port returns the hit ratio rounded once to f32; the reference
    averages in f32 in XLA's summation order, which may round an ulp
    either way of it."""
    rng = np.random.default_rng(seed)
    pred = rng.integers(-1, 40, (16, 10)).astype(np.int32)
    gt = rng.integers(0, 40, (16, 10)).astype(np.int32)
    gt[:4] = pred[:4]                       # some queries all hits
    hits = (pred[:, :, None] == gt[:, None, :]).any(axis=1)
    exact = np.float32(hits.mean(axis=1, dtype=np.float64).mean())
    want = np.float32(jmetrics.intersection_recall(jnp.asarray(pred),
                                                   jnp.asarray(gt)))
    got = tmetrics.intersection_recall(torch.from_numpy(pred),
                                       torch.from_numpy(gt))
    assert got.dtype == torch.float32 and np.float32(got) == exact
    assert abs(np.float32(got) - want) <= np.spacing(want)


@pytest.mark.parametrize("seed", [0, 1])
def test_distance_error_stats_match_reference(seed):
    rng = np.random.default_rng(seed)
    exact = rng.uniform(0.0, 100.0, (8, 37)).astype(np.float32)
    exact[0, :3] = 0.0                      # the 1e-12 floor
    approx = (exact + rng.normal(0, 0.5, exact.shape)).astype(np.float32)
    want = jmetrics.distance_error_stats(jnp.asarray(approx),
                                         jnp.asarray(exact))
    got = tmetrics.distance_error_stats(torch.from_numpy(approx),
                                        torch.from_numpy(exact))
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key] == pytest.approx(want[key], rel=1e-6), key


def test_kmeans_is_seeded_and_converges():
    rng = np.random.default_rng(8)
    centers = rng.normal(0, 10, (4, 6)).astype(np.float32)
    x = _t(np.concatenate([c + rng.normal(0, 0.1, (50, 6)) for c in centers]
                          ).astype(np.float32))
    a = tkm.kmeans(x, 4, 10, generator=torch.Generator().manual_seed(0))
    b = tkm.kmeans(x, 4, 10, generator=torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(a.centroids.numpy(), b.centroids.numpy())
    assert a.assignments.dtype == torch.int32
    # every true cluster is found: within-cluster scatter only
    assert float(a.inertia) < 200 * 6 * 0.1 ** 2 * 3
    multi = tkm.kmeans_multi(torch.stack([x, x * 2]), 4, 10,
                             generator=torch.Generator().manual_seed(1))
    assert multi.centroids.shape == (2, 4, 6)


def test_port_imports_neither_jax_nor_reference():
    """In a fresh interpreter: import every module of repro_torch, then
    no ``jax*`` and no ``repro``/``repro.*`` module may be loaded."""
    code = (
        "import importlib, pkgutil, sys, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib',"
        " 'repro')]\n"
        "assert not bad, bad\n"
        "print(len([k for k in sys.modules if k.startswith('repro_torch')]))\n")
    src = os.path.join(os.path.dirname(__file__), os.pardir, "src")
    env = dict(os.environ, PYTHONPATH=src)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15

#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py [--seed 0] [--n 1000000] [--nt 100000] [--nlist 1024]

Builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` with nvcc,
holds each kernel against its plain PyTorch version on the card at the
shapes the serving path gives it, then serves a SIFT1M-shaped index
(N x 128 f32 base, M=16 4-bit PQ, flat coarse over nlist lists) through
``SearchEngine.build`` and ``search_jit`` at the serving buckets
Q in {1, 8, 32, 128}, with k=10, nprobe=8, rerank_mult=4, plus one batch
with a filter bitmap. It checks that both kernels ran on that path, that
one Q=32 batch equals the port's own pipeline on CPU copies of the same
index (the plain versions), and prints recall against exact ground truth.

Prints the card's name and power limit, timings, a ``{"kernels": [...]}``
line, and as the last line ``{"ok": true, "device": {...}}``. Any failure
exits non-zero. Needs a CUDA card and the repo's ``src/`` beside it; it
imports neither jax nor the JAX package.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate
CUDA_CORE_OPS_PER_S = 67e12   # H100 SXM f32 rate outside the tensor cores
BUCKETS = (1, 8, 32, 128)
BATCHES_PER_BUCKET = 3
K, NPROBE, RERANK_MULT, M = 10, 8, 4, 16
K2_RTOL = 1e-6                # of ||q||^2 + ||x||^2 (see k2_phase)
PIPELINE_RTOL = 1e-5          # card vs host f32 pipeline


def log(*parts) -> None:
    print(*parts, flush=True)


def device_ms(torch, fn, kernel_name: str, iters: int):
    """Mean device time of the named kernel per call of ``fn``, from the
    profiler's CUDA trace; None when the trace holds no device time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for ev in prof.key_averages():
        if kernel_name in ev.key:
            total += getattr(ev, "device_time_total",
                             getattr(ev, "cuda_time_total", 0.0))
    return total / iters / 1e3 if total > 0 else None


def event_ms(torch, fn, iters: int, warmup: int = 3) -> float:
    """Mean time per call of ``fn`` over ``iters`` back-to-back calls, by
    CUDA events (includes any host launch gaps)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def breakdown(torch, fn):
    """One call of ``fn`` under the profiler: (wall ms, device ms summed over
    its device ops, device ops, [(name, device ms)] largest first). The
    profiler slows the host, so the wall time here is not a latency."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows, launches = [], 0
    for ev in prof.key_averages():
        if "CUDA" not in str(ev.device_type):
            continue          # host ops: their device time is their kernels'
        dev = getattr(ev, "self_device_time_total",
                      getattr(ev, "self_cuda_time_total", 0.0))
        if dev > 0:
            rows.append((ev.key, dev / 1e3))
            launches += ev.count
    rows.sort(key=lambda r: -r[1])
    return wall, sum(r[1] for r in rows), launches, rows


def tie_groups(vals: np.ndarray, tol: np.ndarray):
    """Runs [i, j) of neighbouring values within ``tol`` of each other."""
    i, k = 0, vals.shape[0]
    while i < k:
        j = i + 1
        while j < k and abs(vals[j] - vals[j - 1]) <= tol:
            j += 1
        yield i, j
        i = j


def assert_tie_aware(got_v, got_i, want_v, want_i, tol, what: str) -> None:
    """Values within ``tol`` (per query), ids equal up to order inside runs
    of values within ``tol`` of each other; infinite tails must agree."""
    for q in range(want_v.shape[0]):
        fin = np.isfinite(want_v[q])
        if not np.array_equal(fin, np.isfinite(got_v[q])):
            raise AssertionError(f"{what}: query {q} finite pattern differs")
        err = np.abs(got_v[q][fin] - want_v[q][fin])
        if (err > tol[q]).any():
            raise AssertionError(f"{what}: query {q} value error {err.max()} "
                                 f"> {tol[q]}")
        for i, j in tie_groups(want_v[q], tol[q]):
            if sorted(got_i[q, i:j]) != sorted(want_i[q, i:j]):
                raise AssertionError(
                    f"{what}: query {q} ids differ in ranks [{i}, {j}): "
                    f"{got_i[q, i:j]} vs {want_i[q, i:j]}")


def k1_phase(torch, args, cap: int, nlist: int):
    from repro_torch.core.lists import filter_words
    from repro_torch.kernels import fastscan_kernel as fk
    from repro_torch.kernels import ops
    dev = torch.device("cuda")
    g = 128 * NPROBE
    keep = RERANK_MULT * K
    tile = ops._stream_tile(cap)
    kc = max(1, min(keep, tile))
    rng = np.random.default_rng(args.seed + 1)
    mh = M // 2
    w = filter_words(cap)
    codes = torch.as_tensor(rng.integers(0, 256, (nlist, cap, mh), np.uint8),
                            device=dev)
    table = torch.as_tensor(rng.integers(0, 256, (g, M, 16), np.uint8),
                            device=dev)
    sizes_np = rng.integers(0, cap + 1, nlist).astype(np.int32)
    probes_np = rng.integers(0, nlist, g).astype(np.int32)
    probes_np[rng.random(g) < 0.05] = -1
    bits_np = rng.integers(0, 256, (nlist, w), np.uint8)   # ~50% pass
    sizes = torch.as_tensor(sizes_np, device=dev)
    probes = torch.as_tensor(probes_np, device=dev)
    bits = torch.as_tensor(bits_np, device=dev)

    def kernel():
        return fk.fastscan_stream_topk_grouped(table, codes, probes, sizes,
                                               kc=kc, tile_n=tile,
                                               filter_bits=bits)

    def plain():
        return fk.fastscan_stream_topk_plain(table, codes, probes, sizes,
                                             kc=kc, tile_n=tile,
                                             filter_bits=bits)

    got, want = kernel(), plain()
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        if not torch.equal(a, b):
            bad = int((a != b).sum())
            raise AssertionError(f"K1: kernel != plain in {bad} entries")
    ms_events = event_ms(torch, kernel, 50)
    ms_dev = device_ms(torch, kernel, "stream_topk_kernel", 20)
    plain_ms = event_ms(torch, plain, 5, warmup=1)
    # bound: what this run's data needs -- each distinct probed list's rows
    # that are occupied and pass the filter read once (M/2 bytes a row), its
    # bitmap words and size, every LUT and probe id, the outputs written once
    distinct = np.unique(probes_np[probes_np >= 0])
    passing = np.unpackbits(bits_np, axis=1, bitorder="little")[:, :cap]
    live = passing & (np.arange(cap)[None, :] < sizes_np[:, None])
    live_rows = live[distinct].sum()
    n_tiles = cap // tile
    nbytes = (live_rows * mh + distinct.size * (w + 4) + g * M * 16 + g * 4
              + 2 * g * n_tiles * kc * 4)
    group_rows = live[probes_np[probes_np >= 0]].sum()
    ops_count = group_rows * M * 2          # M look-ups + M adds a row
    bound = max(nbytes / HBM_BYTES_PER_S, ops_count / CUDA_CORE_OPS_PER_S)
    by = "bytes" if nbytes / HBM_BYTES_PER_S >= ops_count / CUDA_CORE_OPS_PER_S \
        else "operations"
    ms = ms_dev if ms_dev is not None else ms_events
    log(f"K1 fastscan_stream_topk: G={g} nlist={nlist} cap={cap} M={M} "
        f"tile={tile} kc={kc} filter~50% invalid_probes="
        f"{int((probes_np < 0).sum())}: kernel == plain bit for bit")
    log(f"K1 time: device {ms_dev} ms, events {ms_events:.5f} ms, plain "
        f"{plain_ms:.5f} ms, bound {bound * 1e3:.6f} ms ({by}: "
        f"{nbytes} B, {ops_count} int ops)")
    return {"name": "fastscan_stream_topk", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/fastscan_stream_topk.cu",
            "replaces": "src/repro/kernels/fastscan_kernel.py:788",
            "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound * 1e3, "bound_by": by, "library_ms": None}


def k2_phase(torch, args, base, norms):
    from repro_torch.kernels import ops
    from repro_torch.kernels import rerank_kernel as rk
    dev = base.device
    qq, r, kk = 128, RERANK_MULT * K, K
    n, d = base.shape
    tile = ops._rerank_tile(r)
    rp = -(-r // tile) * tile
    rng = np.random.default_rng(args.seed + 2)
    cand_np = np.full((qq, rp), -1, np.int32)
    cand_np[:, :r] = rng.integers(0, n, (qq, r))
    cand_np[0, r - 5:r] = -1                   # a query with a short list
    qrows = torch.as_tensor(rng.integers(0, n, qq), device=dev)
    q = (base[qrows] + torch.randn(qq, d, device=dev,
                                   generator=torch.Generator(device=dev).manual_seed(
                                       args.seed))).contiguous()
    cand = torch.as_tensor(cand_np, device=dev)
    xn = norms[cand.clamp_min(0).long()].contiguous()

    def kernel():
        return rk.rerank_stream_topk(base, q, cand, xn, k=kk, tile_r=tile)

    def plain():
        return rk.rerank_stream_topk_plain(base, q, cand, xn, k=kk,
                                           tile_r=tile)

    (gv, gp), (pv, pp) = kernel(), plain()
    torch.cuda.synchronize()
    gv, gp, pv, pp = (t.cpu().numpy() for t in (gv, gp, pv, pp))
    # reduction order differs, so the error scales with the terms whose
    # sum is rounded: tolerance = K2_RTOL * (||q||^2 + max ||x||^2)
    qn = (q * q).sum(-1).cpu().numpy()
    tol = K2_RTOL * (qn + xn.max(dim=1).values.cpu().numpy())
    assert_tie_aware(gv, gp, pv, pp, tol, "K2")
    fin = np.isfinite(pv)
    max_err = float(np.abs(gv[fin] - pv[fin]).max())
    ms_events = event_ms(torch, kernel, 100)
    ms_dev = device_ms(torch, kernel, "rerank_kernel", 50)
    plain_ms = event_ms(torch, plain, 20, warmup=2)
    valid = int((cand_np >= 0).sum())
    nbytes = valid * d * 4 + qq * d * 4 + 2 * qq * rp * 4 + qq * kk * 8
    flops = 2 * valid * d
    bound = max(nbytes / HBM_BYTES_PER_S, flops / CUDA_CORE_OPS_PER_S)
    by = "bytes" if nbytes / HBM_BYTES_PER_S >= flops / CUDA_CORE_OPS_PER_S \
        else "operations"
    ms = ms_dev if ms_dev is not None else ms_events
    log(f"K2 rerank_stream_topk: Q={qq} R={r} Rp={rp} D={d} k={kk} N={n}: "
        f"max |kernel - plain| = {max_err} (tolerance {K2_RTOL} x "
        f"(|q|^2 + max |x|^2), up to {tol.max()}), positions tie-aware equal")
    log(f"K2 time: device {ms_dev} ms, events {ms_events:.5f} ms, plain "
        f"{plain_ms:.5f} ms, bound {bound * 1e3:.6f} ms ({by}: {nbytes} B, "
        f"{flops} flop)")
    return {"name": "rerank_stream_topk", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/rerank_stream_topk.cu",
            "replaces": "src/repro/kernels/rerank_kernel.py:213",
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound * 1e3, "bound_by": by, "library_ms": None}


def check_result(torch, res, qq: int, n: int, what: str) -> None:
    ids, dists = res.ids, res.dists
    if ids.shape != (qq, K) or dists.shape != (qq, K):
        raise AssertionError(f"{what}: shapes {ids.shape} {dists.shape}")
    ok = ids >= 0
    if not bool(ok.all()):
        raise AssertionError(f"{what}: {int((~ok).sum())} empty result slots")
    if not bool(torch.isfinite(dists).all()) or bool((ids >= n).any()):
        raise AssertionError(f"{what}: non-finite distance or id out of range")
    if not bool((dists[:, 1:] >= dists[:, :-1]).all()):
        raise AssertionError(f"{what}: distances not ascending")


def slice_phase(torch, args, engine, ds, build_s):
    from repro_torch import interop
    from repro_torch.core.lists import pack_filter_mask
    from repro_torch.core.metrics import recall_at_r
    from repro_torch.kernels import fastscan_kernel as fk
    from repro_torch.kernels import rerank_kernel as rk
    n = ds.base.shape[0]
    queries = ds.queries
    # warm-up of every bucket (allocator, cuBLAS handles), not timed
    off = 0
    for qq in BUCKETS:
        engine.search_jit(queries[off:off + qq], K, nprobe=NPROBE,
                          rerank_mult=RERANK_MULT)
        off += qq
    torch.cuda.synchronize()
    rng = np.random.default_rng(args.seed + 3)
    lists = engine.index.lists
    mask = torch.as_tensor(rng.random((lists.nlist, lists.cap)) < 0.5,
                           device=lists.ids.device) & (lists.ids >= 0)
    fbits = pack_filter_mask(mask)
    torch.cuda.reset_peak_memory_stats()
    fk.launches = 0
    rk.launches = 0
    lat: dict[int, list[float]] = {qq: [] for qq in BUCKETS}
    kept = {}
    rec_ids, rec_gt = [], []
    for _ in range(BATCHES_PER_BUCKET):
        for qq in BUCKETS:
            q = queries[off:off + qq]
            t0 = time.perf_counter()
            res = engine.search_jit(q, K, nprobe=NPROBE,
                                    rerank_mult=RERANK_MULT)
            torch.cuda.synchronize()
            lat[qq].append((time.perf_counter() - t0) * 1e3)
            check_result(torch, res, qq, n, f"Q={qq}")
            if qq == 32 and "plain" not in kept:
                kept["plain"] = (off, None, res)
            if qq == 128:
                rec_ids.append(res.ids)
                rec_gt.append(ds.gt_ids[off:off + qq])
            off += qq
    q = queries[off:off + 32]
    t0 = time.perf_counter()
    res = engine.search_jit(q, K, nprobe=NPROBE, rerank_mult=RERANK_MULT,
                            filter_bits=fbits)
    torch.cuda.synchronize()
    filt_ms = (time.perf_counter() - t0) * 1e3
    kept["filtered"] = (off, fbits, res)
    launches = {"fastscan_stream_topk": fk.launches,
                "rerank_stream_topk": rk.launches}
    peak = torch.cuda.max_memory_allocated()
    log(f"slice: kernel launches on the main path {launches}")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel was not launched: {launches}")
    if int(res.stats.rows_filtered.sum()) <= 0:
        raise AssertionError("filtered batch excluded no row")
    ids_f = res.ids[res.ids >= 0].long()
    ok = mask.reshape(-1)  # membership check through the store's ids
    allowed = torch.zeros(n, dtype=torch.bool, device=ok.device)
    allowed[lists.ids.reshape(-1)[ok]] = True
    if not bool(allowed[ids_f].all()):
        raise AssertionError("filtered batch returned a filtered-out row")

    # the same batches through the port on CPU copies (plain versions)
    t0 = time.perf_counter()
    host = interop.engine_from_arrays(interop.arrays_from_engine(engine),
                                      config=engine.config, device="cpu")
    for what, (o, fb, res) in kept.items():
        want = host.search_jit(queries[o:o + 32].cpu(), K, nprobe=NPROBE,
                               rerank_mult=RERANK_MULT,
                               filter_bits=None if fb is None else fb.cpu())
        wv, wi = want.dists.numpy(), want.ids.numpy()
        gv, gi = res.dists.cpu().numpy(), res.ids.cpu().numpy()
        tol = PIPELINE_RTOL * np.abs(wv).max(axis=1)
        assert_tie_aware(gv, gi, wv, wi, tol, f"card vs host ({what})")
        for f in want.stats._fields:
            a = getattr(res.stats, f).cpu().numpy()
            b = getattr(want.stats, f).numpy()
            if not np.array_equal(a, b):
                raise AssertionError(f"card vs host ({what}): stats.{f}")
    log(f"slice: Q=32 batches (plain and filtered) equal the host pipeline "
        f"(ids tie-aware, dists rtol {PIPELINE_RTOL}, QueryStats exact) "
        f"[{time.perf_counter() - t0:.1f} s]")
    ids = torch.cat(rec_ids)
    gt = torch.cat(rec_gt)
    r1 = float(recall_at_r(ids, gt, 1))
    r10 = float(recall_at_r(ids, gt, 10))
    log(f"slice: recall@1 {r1:.4f} recall@10 {r10:.4f} over {ids.shape[0]} "
        f"queries (k={K}, nprobe={NPROBE}, rerank_mult={RERANK_MULT})")
    for qq in BUCKETS:
        v = lat[qq]
        log(f"slice: Q={qq} batch latency ms (host clock, synchronized): "
            f"{' '.join(f'{x:.3f}' for x in v)}; QPS at the median "
            f"{qq / (sorted(v)[len(v) // 2] / 1e3):.1f}")
    # where one batch's time goes: device kernels against the host clock
    for qq in BUCKETS:
        q = queries[:qq]
        wall, dev_ms, n_kern, rows = breakdown(
            torch, lambda: engine.search_jit(q, K, nprobe=NPROBE,
                                             rerank_mult=RERANK_MULT))
        med = sorted(lat[qq])[len(lat[qq]) // 2]
        log(f"slice: Q={qq} profiled batch: device busy {dev_ms:.4f} ms in "
            f"{n_kern} device ops = {100 * dev_ms / med:.1f}% of the median "
            f"unprofiled latency {med:.3f} ms (idle "
            f"{100 * (1 - dev_ms / med):.1f}%); profiled wall {wall:.3f} ms")
        for name, ms in rows[:6]:
            log(f"    {ms:.4f} ms  {name[:90]}")
    log(f"slice: Q=32 filtered batch {filt_ms:.3f} ms; "
        f"max_memory_allocated {peak} B; index build {build_s:.2f} s")
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--nt", type=int, default=100_000)
    ap.add_argument("--nlist", type=int, default=1024)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(root, "src"))
    import repro_torch  # noqa: F401  (fails outside the repo)
    from repro_torch.data.vectors import make_sift_like
    from repro_torch.engine import EngineConfig, SearchEngine
    from repro_torch.core.lists import grow_cap
    from repro_torch.kernels import _build
    from repro_torch.kernels.fastscan_kernel import TILE_N

    # 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    log(smi)
    log(f"device: {name}; torch {torch.__version__} cuda {torch.version.cuda}")

    # 2. build
    t0 = time.perf_counter()
    _build.load_library()
    log(f"build: {time.perf_counter() - t0:.2f} s (nvcc {_build.build_seconds:.2f} s)")
    log(_build.build_log)

    # set-up: data and the index the slice phase serves (its cap shapes K1)
    t0 = time.perf_counter()
    nq = (BATCHES_PER_BUCKET + 1) * sum(BUCKETS) + 32
    ds = make_sift_like(n=args.n, nt=args.nt, nq=nq, d=128, seed=args.seed,
                        device="cuda")
    torch.cuda.synchronize()
    log(f"data: {args.n} x 128 base, {args.nt} train, {nq} queries, exact "
        f"ground truth on the card [{time.perf_counter() - t0:.1f} s]")
    t0 = time.perf_counter()
    engine = SearchEngine.build(ds.train, ds.base, m=M, nlist=args.nlist,
                                config=EngineConfig(nprobe=NPROBE,
                                                    rerank_mult=RERANK_MULT),
                                seed=args.seed, device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    # headroom as a deployment leaves it for upserts: cap rounded up to a
    # multiple of the scan's default tile, so the stream scan runs
    # TILE_N-row tiles whatever the largest list's size factors into
    raw_cap = engine.index.cap
    cap = -(-raw_cap // TILE_N) * TILE_N
    engine = SearchEngine(
        engine.index._replace(lists=grow_cap(engine.index.lists, cap)),
        base=engine.base, config=engine.config, base_norms=engine.base_norms)
    sizes = engine.index.lists.sizes
    log(f"index: nlist={args.nlist} cap={cap} (largest list {raw_cap}) M={M}, "
        f"list sizes min {int(sizes.min())} mean "
        f"{float(sizes.float().mean()):.1f}, built in {build_s:.2f} s")

    # 3-4. kernels against their plain versions
    k1 = k1_phase(torch, args, engine.index.cap, args.nlist)
    k2 = k2_phase(torch, args, engine.base, engine.base_norms)

    # 5. the serving path
    launches = slice_phase(torch, args, engine, ds, build_s)
    k1["launches"] = launches["fastscan_stream_topk"]
    k2["launches"] = launches["rerank_stream_topk"]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    log(json.dumps({"kernels": [{key: kern[key] for key in keys}
                                for kern in (k1, k2)]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

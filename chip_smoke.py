#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py [--seed 0] [--n 1000000] [--nt 100000] [--nlist 1024]

Builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` with nvcc,
holds each kernel (K1-K6) against its plain PyTorch version on the card at
the shapes the serving paths give it (K2 also at Q = 1 and 8 and at
tiles 16 and 32, K3 and K5 also at one query's 32 groups), then serves a
SIFT1M-shaped index
(N x 128 f32 base, M=16 4-bit PQ, flat coarse over nlist lists) built by
``SearchEngine.build``, through ``search_jit`` (CUDA graphs) at the
serving buckets
Q in {1, 8, 32, 128} plus one batch with a filter bitmap, on two paths:

  1. the stream path: k=10, nprobe=8, rerank_mult=4, the stream scan (K1)
     and the stream re-rank (K2);
  2. the anytime, autotuned path (docs/anytime.md's configuration):
     nprobe=32, probe_policy='margin', margin_tau=0.4, early_exit=True,
     scan_impl='auto', rerank_mult=4, rerank_impl='auto'; it prints the
     autotune verdicts, forces 'select' (K5), 'mxu' (K6) and 'stream' with
     early exit (K4) in further batches and calls ``SearchEngine.scan`` on
     a stream engine (K3), checks that early exit and margin_tau=inf are
     lossless (bitwise).

  3. the flat path (the paper's Fig. 2 pair): a flat fast-scan index
     (``core.fastscan.build_index``, M=16) over the same base, searched
     with impl='mxu' (K7b) and impl='select' (K7a) beside the naive-PQ
     baseline (``core.pq.search``), plus one ``ops.fastscan_blockmin``
     (K7c) over the million codes; 'select' must equal 'mxu' bit for bit
     and the recall@10 gap between fast-scan and naive PQ stay under 0.05.

  4. live mutation on the stream path's configuration, on an engine of
     its own over the stream engine's index (its first write clones the
     store and base, and the stream engine's are checked unchanged after
     the phase): compact to cap 5120,
     10,000 new ids, 10,000 deletes and 2,000 re-upserts in batches of
     1,000, compact; after each batch ``search_jit`` == ``search`` bit for
     bit, no deleted id returned and each upserted row found first at
     distance 0, the graphs kept by every batch that keeps the shapes;
     then the store against a rebuild from its own codes in write order,
     build-time codes against ``encode_rows``, and recall over the
     survivors. It prints upsert rows/s and delete ms a batch, compact
     seconds, the locator's build time, Q=32 ``search_jit`` latency before
     and after, and the graphs dropped.

  5. the stream index across 4 shards (``ShardedEngine``, shards in turn
     on this card; the ``torch.distributed`` path needs a card a rank):
     one shard against the single-host engine, every list probed without
     re-rank against it, recall@10 at least its own, exact distances, the
     stats summed over the shards; then 1,000-row upserts, deletes and
     re-upserts through the shards and the single-host engine alike, and
     compaction, held after the writes and after compaction. It prints
     the batch latency a bucket and the writes' rates.

  6. the coarse zoo, the paper's Table 1 pipeline (benchmarks/table1.py):
     a Deep1B-like N x 96 base, nlist = sqrt(N), M=16, built by
     ``SearchEngine.build(coarse='hnsw', hnsw_m=16, ef_construction=64)``,
     with a k-means-tree and a flat-coarse engine over the same index; at
     nprobe 1, 2, 4, 8 and rerank_mult 0 and 4: recall@1 and @10 of each,
     ``search_jit`` == ``search`` bit for bit (HNSW, tree) and no repeated
     probe. It prints the HNSW build's seconds, the coarse stage's device
     time and device ops beside the whole query's graph, and graph
     latency a bucket.

  7. durable serving (``repro_torch.serving`` over ``repro_torch.persist``)
     on the stream configuration, an engine of its own over the stream
     index compacted to cap 5120: a ``ServingLoop`` booted with a snapshot
     directory (git-ignored ``build/``) and warmed a bucket; closed-loop
     clients at 1, 8, 32 and 128 threads (QPS, p50/p99, occupancy,
     buckets; every served row held against ``search``, tie-aware, stats
     exact; no capture or sweep after warm-up); reads at 32 clients under
     1,000-row upserts and deletes with the WAL fsync'd and two forced
     delta checkpoints (p99 with and without one running, the capture's
     device time, bytes written and reused, upsert rows/s); recovery with
     ``persist.open_engine`` on the card, bit for bit; a primary and a
     standby loop over a ``DirTransport`` (lag, ``promote()`` seconds, the
     acknowledged prefix held, the old primary fenced, standby reads never
     failing); and ``tools/crash_test_torch.py`` once a drill.

``search_jit`` replays one captured CUDA graph per key, so the timed
batches of both IVF paths are graph replays. A graph phase on each IVF path
(the stream configuration, and the anytime one under verdicts pinned in a
v3 autotune file written here) then holds ``search_jit`` bit for bit
against the eager ``search`` at every bucket, for a filtered Q=32 batch, a
per-query tau batch (anytime) and a namespaced Q=32 batch (stream: 4
tenants each owning a random quarter of the lists, a quarter of the
queries unrestricted; also held against the host pipeline and checked for
isolation), checks that steady traffic and new values at a seen key
capture no graph (``fused_cache_size``), and times eager and graph in turns
(host clock with and without synchronize, profiler busy time, the replay's
CUDA-event time, each key's capture time, the graphs' memory).

For each path it checks that the path's kernels ran (a replay adds the
launches its graph holds to the kernels' counters), that one Q=32 batch
equals the port's own pipeline on CPU copies of the same index (the plain
versions), and prints recall against exact ground truth, batch latencies
and a profiler breakdown. Every kernel (K1-K6, K7a-K7c) is also held bit
for bit (K2 within tolerance) against its plain version at the shapes its
path gives it, and timed beside its bound: the larger of the bytes the
function must move at the memory rate and the function's own operations
(for an ADC scan one look-up and one add per row and sub-space) at the
card's fastest rate for their type.

Beside the kernels it times two yardsticks, neither a port: a ``fill_`` of
the flat path's (Q, N) output (the store floor of K7a/K7b) and the card's
rate of independent u8 ``mma.sync.m16n8k32`` (the instruction of the
one-hot scans K6, K7b and K7c), against which each one-hot scan's MMA
count is printed as a time.

Prints the card's name and power limit, timings, a ``{"kernels": [...]}``
line, and as the last line ``{"ok": true, "device": {...}}``. Any failure
exits non-zero. Needs a CUDA card and the repo's ``src/`` beside it; it
imports neither jax nor the JAX package.
"""
from __future__ import annotations

import argparse
import cProfile
import gc
import json
import os
import pstats
import subprocess
import sys
import time

import numpy as np

# The peaks every bound_ms divides by (H100 SXM data sheet, dense, 700 W):
# the device memory rate; the card's fastest integer rate (int8 on the
# tensor cores), for the integer look-ups and adds of the ADC scans; the
# f32 rate outside the tensor cores, for the exact re-rank's products.
HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 1979e12
F32_OPS_PER_S = 67e12
BUCKETS = (1, 8, 32, 128)
DEVICE = "cuda"
BATCHES_PER_BUCKET = 3
GRAPH_ROUNDS = 6              # eager/graph turns a bucket (graph phase)
N_TENANTS = 4                 # the namespaced batch's tenants
K, NPROBE, RERANK_MULT, M = 10, 8, 4, 16
K2_RTOL = 1e-6                # of ||q||^2 + ||x||^2 (see k2_phase)
PIPELINE_RTOL = 1e-5          # card vs host f32 pipeline
AT_NPROBE, AT_TAU = 32, 0.4   # the anytime path's nprobe and margin width
AT_QMAX = 128                 # K3-K6 phases run at G = AT_QMAX * AT_NPROBE
FIG2_GAP = 0.05               # |recall@10 fast-scan - naive PQ| allowed
# device ms of the redesigned kernels' previous versions at these same
# shapes (the last chip_smoke.py run before their redesign, NVIDIA H100
# 80GB HBM3, 700 W), printed beside this run's times; not part of the
# kernels line
EARLIER_MS = {"fastscan_stream_topk": 0.182801,
              "rerank_stream_topk": 0.009445,
              "fastscan_stream_grouped": 0.074477,
              "fastscan_select_grouped": 0.181785,
              "fastscan_onehot_mma_flat": 0.424301,
              "fastscan_onehot_mma_grouped": 1.247889,
              "fastscan_blockmin": 0.425841}
# K2 at the stream path's shape (R = RERANK_MULT * K candidates, k = K) over
# (Q, tile_r), and K3 and K5 over G = AT_NPROBE (one query's probes, the
# anytime path's Q = 1 bucket) as well as the path's G: device ms of the
# first versions at these shapes (the mean of two runs of
# tools/time_port_kernels.py on the tree before their redesign, in one
# call, NVIDIA H100 80GB HBM3, 700 W), printed beside this run's times;
# not part of the kernels line
K2_SHAPES = ((128, 64), (8, 64), (1, 64), (128, 32), (128, 16))
EARLIER_K2_MS = {(128, 64): 0.009459, (8, 64): 0.009129, (1, 64): 0.008630,
                 (128, 32): 0.011183, (128, 16): 0.011353}
EARLIER_K3_MS = {32: 0.002915}
EARLIER_K5_MS = {32: 0.003031}
# kernels whose ptxas registers and spills are summarised after the build
PTXAS_SUMMARY = ("stream_topk_kernel", "rerank_kernel",
                 "stream_grouped_kernel", "select_grouped_kernel",
                 "onehot_mma_flat_kernel", "onehot_mma_grouped_kernel",
                 "blockmin_kernel")


def log(*parts) -> None:
    print(*parts, flush=True)


def ptxas_summary(build_log: str, names) -> list[str]:
    """Registers and spill bytes of each compiled entry function whose
    (mangled) name holds one of ``names``, from nvcc's -Xptxas -v log."""
    out, entry, spill = [], None, ""
    for line in build_log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "spill stores" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line and entry:
            if any(name in entry for name in names):
                regs = line.split("Used")[1].split("registers")[0].strip()
                out.append(f"{entry}: {regs} registers; {spill}")
            entry = None
    return out


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
    ops_count = int(group_rows) * M * 2     # M look-ups + M adds a row
    bound, by = bound_ms(int(nbytes), ops_count, INT_OPS_PER_S)
    ms = ms_dev if ms_dev is not None else ms_events
    log(f"K1 fastscan_stream_topk: G={g} nlist={nlist} cap={cap} M={M} "
        f"tile={tile} kc={kc} filter~50% invalid_probes="
        f"{int((probes_np < 0).sum())}: kernel == plain bit for bit")
    log(f"K1 time: device {ms_dev} ms, events {ms_events:.5f} ms, plain "
        f"{plain_ms:.5f} ms, bound {bound:.6f} ms ({by}: "
        f"{nbytes} B, {ops_count} int ops)")
    return {"name": "fastscan_stream_topk", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/fastscan_stream_topk.cu",
            "replaces": "src/repro/kernels/fastscan_kernel.py:788",
            "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": None}


def k2_inputs(torch, seed: int, base, norms, qq: int, tile: int):
    """K2's operands at the stream path's shape for qq queries: R =
    RERANK_MULT * K random candidate ids padded with -1 to a ``tile``
    multiple (query 0 five short), queries near base rows."""
    dev = base.device
    n, d = base.shape
    r = RERANK_MULT * K
    rp = -(-r // tile) * tile
    rng = np.random.default_rng(seed + 2)
    cand_np = np.full((qq, rp), -1, np.int32)
    cand_np[:, :r] = rng.integers(0, n, (qq, r))
    cand_np[0, r - 5:r] = -1                   # a query with a short list
    qrows = torch.as_tensor(rng.integers(0, n, qq), device=dev)
    q = (base[qrows] + torch.randn(qq, d, device=dev,
                                   generator=torch.Generator(device=dev).manual_seed(
                                       seed))).contiguous()
    cand = torch.as_tensor(cand_np, device=dev)
    xn = norms[cand.clamp_min(0).long()].contiguous()
    return q, cand, xn, int((cand_np >= 0).sum())


def k2_phase(torch, args, base, norms):
    """K2 held (tie-aware, within K2_RTOL) and timed at every (Q, tile_r)
    of K2_SHAPES; the stream path's own shape (Q = 128, its tile) is the
    kernels line's entry."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import rerank_kernel as rk
    kk = K
    n, d = base.shape
    path_tile = ops._rerank_tile(RERANK_MULT * K)
    entry = None
    for qq, tile in K2_SHAPES:
        q, cand, xn, valid = k2_inputs(torch, args.seed, base, norms, qq,
                                       tile)
        rp = cand.shape[1]

        def kernel():
            return rk.rerank_stream_topk(base, q, cand, xn, k=kk,
                                         tile_r=tile)

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
        assert_tie_aware(gv, gp, pv, pp, tol, f"K2 Q={qq} tile={tile}")
        fin = np.isfinite(pv)
        max_err = float(np.abs(gv[fin] - pv[fin]).max())
        ms_dev = device_ms(torch, kernel, "rerank_kernel", 50)
        nbytes = valid * d * 4 + qq * d * 4 + 2 * qq * rp * 4 + qq * kk * 8
        flops = 2 * valid * d
        bound, by = bound_ms(nbytes, flops, F32_OPS_PER_S)
        earlier = EARLIER_K2_MS.get((qq, tile))
        log(f"K2 at Q={qq} tile={tile} (Rp={rp}): device {ms_dev} ms, "
            f"{earlier if earlier is not None else 'not measured'} ms "
            f"before its redesign, bound {bound:.6f} ms; max |kernel - "
            f"plain| = {max_err}, positions tie-aware equal")
        if (qq, tile) != (128, path_tile):
            continue
        ms_events = event_ms(torch, kernel, 100)
        plain_ms = event_ms(torch, plain, 20, warmup=2)
        ms = ms_dev if ms_dev is not None else ms_events
        log(f"K2 rerank_stream_topk: Q={qq} R={RERANK_MULT * K} Rp={rp} "
            f"D={d} k={kk} N={n}: max |kernel - plain| = {max_err} "
            f"(tolerance {K2_RTOL} x (|q|^2 + max |x|^2), up to "
            f"{tol.max()}), positions tie-aware equal")
        log(f"K2 time: device {ms_dev} ms, events {ms_events:.5f} ms, plain "
            f"{plain_ms:.5f} ms, bound {bound:.6f} ms ({by}: {nbytes} B, "
            f"{flops} flop)")
        entry = {"name": "rerank_stream_topk", "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/rerank_stream_topk.cu",
                 "replaces": "src/repro/kernels/rerank_kernel.py:213",
                 "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
                 "bound_ms": bound, "bound_by": by, "library_ms": None}
    return entry


def check_result(torch, dists, ids, qq: int, n: int, what: str) -> None:
    """(Q, K) results: every slot filled, finite, ids in range, ascending."""
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
    # warm-up of every bucket (each captures its graph), not timed
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
    zero_counts()
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
            check_result(torch, res.dists, res.ids, qq, n, f"Q={qq}")
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


def kernel_modules():
    """Every kernel module of the port, by the name of its kernel."""
    from repro_torch.kernels import blockmin_kernel as bk
    from repro_torch.kernels import fastscan_kernel as fk
    from repro_torch.kernels import mxu_flat_kernel as mfk
    from repro_torch.kernels import mxu_kernel as mk
    from repro_torch.kernels import rerank_kernel as rk
    from repro_torch.kernels import select_flat_kernel as sfk
    from repro_torch.kernels import select_kernel as sk
    from repro_torch.kernels import stream_grouped_kernel as sgk
    from repro_torch.kernels import stream_prune_kernel as spk
    return {"fastscan_stream_topk": fk, "rerank_stream_topk": rk,
            "fastscan_stream_grouped": sgk,
            "fastscan_stream_topk_prune": spk,
            "fastscan_select_grouped": sk,
            "fastscan_onehot_mma_grouped": mk,
            "fastscan_select_flat": sfk,
            "fastscan_onehot_mma_flat": mfk,
            "fastscan_blockmin": bk}


def need_launches(launches: dict, names, what: str) -> None:
    """Fail unless each named kernel launched on the path just run."""
    missing = [name for name in names if launches[name] < 1]
    if missing:
        raise AssertionError(f"{what}: {missing} not launched: {launches}")


def zero_counts() -> None:
    for mod in kernel_modules().values():
        mod.launches = 0


def bound_ms(nbytes: int, ops_count: int, peak: float = INT_OPS_PER_S
             ) -> tuple[float, str]:
    """The least time (ms) the card could take for a function, and which
    term binds: the bytes it must move (each input read once, each output
    written once, at the shapes it is launched with) at the memory rate,
    against its own operations at ``peak`` -- for an ADC scan one look-up
    and one add per row and sub-space at the card's fastest integer rate,
    never the ops of a kernel's formulation (a one-hot product's 16x)."""
    t_b = nbytes / HBM_BYTES_PER_S
    t_o = ops_count / peak
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"


def assert_same(got, want, what: str) -> None:
    for i, (a, b) in enumerate(zip(got, want)):
        if not bool((a == b).all()) or a.shape != b.shape:
            raise AssertionError(f"{what}: kernel != plain in output {i} "
                                 f"({int((a != b).sum())} entries)")


def time_kernel(torch, kernel, plain, dev_name: str, nbytes: int,
                ops_count: int, what: str, **entry) -> dict:
    """Profiler and event time of ``kernel``, the plain version's time and
    the bound; the kernel's entry of the kernels line (launches are filled
    in by the path that drives it)."""
    ms_events = event_ms(torch, kernel, 20)
    ms_dev = device_ms(torch, kernel, dev_name, 10)
    plain_ms = event_ms(torch, plain, 3, warmup=1)
    bound, by = bound_ms(nbytes, ops_count)
    log(f"{what} time: device {ms_dev} ms, events {ms_events:.5f} ms, plain "
        f"{plain_ms:.5f} ms, bound {bound:.6f} ms ({by}: {nbytes} B, "
        f"{ops_count} int ops)")
    return dict(entry, route="cuda", max_abs_err=0.0,
                ms=ms_dev if ms_dev is not None else ms_events,
                plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                library_ms=None)


def mma_yardstick(torch) -> float:
    """A yardstick, not a port: the card's rate (MMAs/s) of independent u8
    ``mma.sync.m16n8k32`` from registers, the instruction of the one-hot
    scans (``csrc/yardstick/mma_rate.cu``, built here apart from the
    kernels' library)."""
    import ctypes
    from repro_torch.kernels import _build
    out = _build.build_dir() / "yardstick_mma_rate.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                    str(out), str(_build.CSRC / "yardstick" / "mma_rate.cu")],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    lib.repro_mma_rate.argtypes = [ctypes.c_int, ctypes.c_int,
                                   ctypes.c_void_p, ctypes.c_void_p]
    lib.repro_mma_rate_count.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.repro_mma_rate_count.restype = ctypes.c_longlong
    ctas = 4 * torch.cuda.get_device_properties(0).multi_processor_count
    iters = 2048
    sink = torch.empty(ctas * 256, dtype=torch.int32, device="cuda")

    def run():
        err = lib.repro_mma_rate(ctas, iters, sink.data_ptr(),
                                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"mma_rate: CUDA error {err}")

    ms = event_ms(torch, run, 5)
    rate = lib.repro_mma_rate_count(ctas, iters) / (ms * 1e-3)
    log(f"yardstick: independent u8 mma.sync.m16n8k32 from registers, "
        f"{ctas} CTAs x 8 warps x 8 chains: {rate:.6e} MMAs/s = "
        f"{rate * 16 * 8 * 32 * 2 / 1e12:.2f} TOP/s "
        f"({100 * rate * 16 * 8 * 32 * 2 / INT_OPS_PER_S:.1f}% of "
        f"{INT_OPS_PER_S / 1e12:.0f})")
    return rate


def grouped_phases(torch, args, cap: int, nlist: int) -> list[dict]:
    """K3 over an nlist-list store in place, K5 and K6 over the gathered
    copy the engine builds from it, at the anytime path's largest bucket:
    G = 128 x 32 groups, ~5% -1 probes."""
    from repro_torch.kernels import mxu_kernel as mk
    from repro_torch.kernels import ops
    from repro_torch.kernels import select_kernel as sk
    from repro_torch.kernels import stream_grouped_kernel as sgk
    from repro_torch.kernels.fastscan_kernel import TILE_N
    dev = torch.device("cuda")
    g, mh = AT_QMAX * AT_NPROBE, M // 2
    rng = np.random.default_rng(args.seed + 4)
    store = torch.as_tensor(rng.integers(0, 256, (nlist, cap, mh), np.uint8),
                            device=dev)
    table = torch.as_tensor(rng.integers(0, 256, (g, M, 16), np.uint8),
                            device=dev)
    probes_np = rng.integers(0, nlist, g).astype(np.int32)
    probes_np[rng.random(g) < 0.05] = -1
    probes = torch.as_tensor(probes_np, device=dev)
    valid = probes_np >= 0
    out = []

    tile = ops._stream_tile(cap)

    def k3():
        return sgk.fastscan_stream_grouped(table, store, probes, tile_n=tile)

    def k3_plain():
        return sgk.fastscan_stream_grouped_plain(table, store, probes,
                                                 tile_n=tile)

    assert_same((k3(),), (k3_plain(),), "K3")
    distinct = np.unique(probes_np[valid]).size
    log(f"K3 fastscan_stream_grouped: G={g} nlist={nlist} cap={cap} M={M} "
        f"tile={tile} invalid_probes={int((~valid).sum())}: kernel == plain "
        "bit for bit")
    out.append(time_kernel(
        torch, k3, k3_plain, "stream_grouped_kernel",
        distinct * cap * mh + g * M * 16 + g * 4 + g * cap * 4,
        int(valid.sum()) * cap * M * 2, "K3",
        name="fastscan_stream_grouped",
        source="src/repro_torch/kernels/csrc/fastscan_stream_grouped.cu",
        replaces="src/repro/kernels/fastscan_kernel.py:440"))

    # the gathered copy ListStore.gather makes (zeros for a -1 probe)
    gtile = ops._auto_tile(cap, TILE_N)
    gathered = ops._pad_to(torch.where(
        probes[:, None, None] >= 0, store[probes.clamp_min(0).long()], 0),
        1, gtile).contiguous()
    n_p = gathered.shape[1]

    def plain():
        return sk.fastscan_grouped_plain(table, gathered, tile_n=gtile)

    # mmas: the one-hot product's m16n8k32 MMAs, one a (group, 16 rows,
    # code byte)
    for name, fn, dev_name, src, line, what, mmas in (
            ("fastscan_select_grouped", sk.fastscan_select_tree_grouped,
             "select_grouped_kernel", "fastscan_select_grouped.cu", 167,
             "K5", None),
            ("fastscan_onehot_mma_grouped", mk.fastscan_onehot_mxu_grouped,
             "onehot_mma_grouped_kernel", "fastscan_onehot_mma_grouped.cu",
             267, "K6", g * (n_p // 16) * mh)):
        def kernel(fn=fn):
            return fn(table, gathered, tile_n=gtile)

        assert_same((kernel(),), (plain(),), what)
        log(f"{what} {name}: G={g} N={n_p} M={M} tile={gtile} over the "
            "gathered copy: kernel == plain bit for bit")
        out.append(time_kernel(
            torch, kernel, plain, dev_name,
            g * n_p * mh + g * M * 16 + g * n_p * 4, g * n_p * M * 2, what,
            name=name, source=f"src/repro_torch/kernels/csrc/{src}",
            replaces=f"src/repro/kernels/fastscan_kernel.py:{line}",
            mmas=mmas))
    # K3 and K5 at one query's probes (the anytime path's Q = 1 bucket)
    gs = AT_NPROBE
    t_s, c_s = table[:gs].contiguous(), gathered[:gs].contiguous()
    p_s = probes[:gs].contiguous()
    valid_s = valid[:gs]

    def k3_small():
        return sgk.fastscan_stream_grouped(t_s, store, p_s, tile_n=tile)

    def k5_small():
        return sk.fastscan_select_tree_grouped(t_s, c_s, tile_n=gtile)

    for what, fn, plain_out, dev_name, nbytes, ops_count, earlier in (
            ("K3", k3_small, sgk.fastscan_stream_grouped_plain(
                t_s, store, p_s, tile_n=tile), "stream_grouped_kernel",
             np.unique(probes_np[:gs][valid_s]).size * cap * mh
             + gs * M * 16 + gs * 4 + gs * cap * 4,
             int(valid_s.sum()) * cap * M * 2, EARLIER_K3_MS.get(gs)),
            ("K5", k5_small, sk.fastscan_grouped_plain(t_s, c_s, tile_n=gtile),
             "select_grouped_kernel",
             gs * n_p * mh + gs * M * 16 + gs * n_p * 4, gs * n_p * M * 2,
             EARLIER_K5_MS.get(gs))):
        assert_same((fn(),), (plain_out,), f"{what} G={gs}")
        ms_dev = device_ms(torch, fn, dev_name, 20)
        bound, by = bound_ms(nbytes, ops_count)
        log(f"{what} at G={gs} cap/N={cap if what == 'K3' else n_p} M={M}: "
            f"kernel == plain bit for bit; device {ms_dev} ms, "
            f"{earlier if earlier is not None else 'not measured'} ms before "
            f"its redesign, bound {bound:.6f} ms ({by})")
    return out


def k4_inputs(torch, args, cap: int, nlist: int, qq: int):
    """K4's operands for qq queries x AT_NPROBE probes: ~50% filter, ~5% -1
    probes, and half of each query's groups' biases shifted far (as
    tests/test_anytime.py::_skewed_index does) so that pruning fires."""
    from repro_torch.core.lists import filter_words
    from repro_torch.kernels import ops
    dev = torch.device("cuda")
    g, mh = qq * AT_NPROBE, M // 2
    tile = ops._stream_tile(cap)
    rng = np.random.default_rng(args.seed + 5)
    w = filter_words(cap)
    codes = torch.as_tensor(rng.integers(0, 256, (nlist, cap, mh), np.uint8),
                            device=dev)
    table = torch.as_tensor(rng.integers(0, 256, (g, M, 16), np.uint8),
                            device=dev)
    sizes_np = rng.integers(0, cap + 1, nlist).astype(np.int32)
    probes_np = rng.integers(0, nlist, g).astype(np.int32)
    probes_np[rng.random(g) < 0.05] = -1
    bits_np = rng.integers(0, 256, (nlist, w), np.uint8)      # ~50% pass
    scales_np = rng.uniform(0.5, 2.0, g).astype(np.float32)
    biases_np = rng.uniform(0.0, 50.0, g).astype(np.float32)
    biases_np.reshape(qq, AT_NPROBE)[:, AT_NPROBE // 2:] += 1e4
    sizes, probes, bits, scales, biases = (
        torch.as_tensor(a, device=dev)
        for a in (sizes_np, probes_np, bits_np, scales_np, biases_np))
    acc_min = torch.sum(torch.amin(table, dim=-1), dim=-1, dtype=torch.int32)
    bounds = scales * acc_min.float() + biases
    kw = dict(kc=min(RERANK_MULT * K, tile), tile_n=tile,
              groups_per_query=AT_NPROBE, filter_bits=bits)
    host = dict(sizes=sizes_np, probes=probes_np, bits=bits_np)
    return (table, codes, probes, sizes, bounds, scales, biases), kw, host


def k4_phase(torch, args, cap: int, nlist: int) -> dict:
    """K4 at the anytime path's largest bucket (128 queries x 32 probes),
    timed and held bit for bit against its plain version; then the same
    construction at one query (G = 32, one CTA), held and timed too."""
    from repro_torch.kernels import stream_prune_kernel as spk
    out = None
    for qq in (AT_QMAX, 1):
        args_, kw, host = k4_inputs(torch, args, cap, nlist, qq)

        def kernel():
            return spk.fastscan_stream_topk_prune(*args_, **kw)

        def plain():
            return spk.fastscan_stream_topk_prune_plain(*args_, **kw)

        got = kernel()
        assert_same(got, plain(), f"K4 G={qq * AT_NPROBE}")
        skipped = got[2].cpu().numpy().astype(bool)
        if not skipped.any():
            raise AssertionError("K4: the skewed construction pruned no tile")
        g, tile, kc = qq * AT_NPROBE, kw["tile_n"], kw["kc"]
        n_tiles, mh = cap // tile, M // 2
        probes_np, sizes_np = host["probes"], host["sizes"]
        valid_tiles = int((probes_np >= 0).sum()) * n_tiles
        log(f"K4 fastscan_stream_topk_prune: G={g} ({qq} queries x "
            f"{AT_NPROBE} probes) nlist={nlist} cap={cap} tile={tile} "
            f"kc={kc} filter~50% invalid_probes={int((probes_np < 0).sum())}:"
            f" kernel == plain bit for bit; skipped {int(skipped.sum())} of "
            f"{valid_tiles} valid-probe tiles")
        if qq == 1:
            ms_dev = device_ms(torch, kernel, "stream_topk_prune_kernel", 20)
            ms_ev = event_ms(torch, kernel, 20)
            log(f"K4 at G={g} (one query, one CTA): device {ms_dev} ms, "
                f"events {ms_ev:.5f} ms, "
                f"{valid_tiles - int(skipped.sum())} tiles scanned")
            continue
        # bound: only what this run scanned -- the live rows (occupied,
        # passing the filter) of each distinct (list, tile) it scanned, read
        # once, with their bitmap bytes; every LUT and per-group scalar; the
        # outputs
        scanned = (probes_np >= 0)[:, None] & ~skipped
        passing = np.unpackbits(host["bits"], axis=1,
                                bitorder="little")[:, :cap]
        live = passing & (np.arange(cap)[None, :] < sizes_np[:, None])
        live_tile = live.reshape(nlist, n_tiles, tile).sum(-1)   # (nlist, T)
        gi, ti = np.nonzero(scanned)
        pairs = np.unique(probes_np[gi] * n_tiles + ti)
        nbytes = (int(live_tile.reshape(-1)[pairs].sum()) * mh
                  + pairs.size * (tile // 8 + 4) + g * M * 16 + g * 16
                  + g * n_tiles * (kc * 8 + 4))
        ops_count = int(live_tile[probes_np[gi], ti].sum()) * M * 2
        out = time_kernel(
            torch, kernel, plain, "stream_topk_prune_kernel", nbytes,
            ops_count, "K4", name="fastscan_stream_topk_prune",
            source="src/repro_torch/kernels/csrc/fastscan_stream_topk_prune.cu",
            replaces="src/repro/kernels/fastscan_kernel.py:788")
    return out


def host_twin_check(torch, engine, config, kept, queries, what: str,
                    **search_kw) -> None:
    """The kept Q=32 batches again through the port on CPU copies of the
    index (the plain versions): ids tie-aware, dists rtol PIPELINE_RTOL,
    every QueryStats counter exact."""
    from repro_torch import interop
    t0 = time.perf_counter()
    host = interop.engine_from_arrays(interop.arrays_from_engine(engine),
                                      config=config, device="cpu")
    for name, (o, fb, res) in kept.items():
        want = host.search_jit(queries[o:o + 32].cpu(), K,
                               filter_bits=None if fb is None else fb.cpu(),
                               **search_kw)
        wv, wi = want.dists.numpy(), want.ids.numpy()
        gv, gi = res.dists.cpu().numpy(), res.ids.cpu().numpy()
        tol = PIPELINE_RTOL * np.abs(wv).max(axis=1)
        assert_tie_aware(gv, gi, wv, wi, tol, f"{what} card vs host ({name})")
        for f in want.stats._fields:
            a = getattr(res.stats, f).cpu().numpy()
            b = getattr(want.stats, f).numpy()
            if not np.array_equal(a, b):
                raise AssertionError(f"{what} card vs host ({name}): "
                                     f"stats.{f} {a.sum()} vs {b.sum()}")
    log(f"{what}: Q=32 batches (plain and filtered) equal the host pipeline "
        f"(ids tie-aware, dists rtol {PIPELINE_RTOL}, QueryStats exact) "
        f"[{time.perf_counter() - t0:.1f} s]")


def anytime_config():
    """docs/anytime.md's configuration, the anytime path's."""
    from repro_torch.engine import EngineConfig
    return EngineConfig(nprobe=AT_NPROBE, probe_policy="margin",
                        margin_tau=AT_TAU, early_exit=True, scan_impl="auto",
                        rerank_mult=RERANK_MULT, rerank_impl="auto")


def anytime_phase(torch, args, engine, ds, tuned_file: str) -> dict:
    """The second path: the anytime, autotuned configuration at every
    bucket, then batches that force each scan kernel onto the engine path;
    returns the launch counts of this path."""
    from repro_torch.core.lists import pack_filter_mask
    from repro_torch.core.metrics import recall_at_r
    from repro_torch.engine import SearchEngine
    from repro_torch.kernels import ops
    n = ds.base.shape[0]
    queries = ds.queries
    cfg = anytime_config()

    def with_cfg(**kw):
        return SearchEngine(engine.index, base=engine.base,
                            base_norms=engine.base_norms,
                            config=cfg._replace(**kw))

    at = with_cfg()
    # warm-up of every bucket: resolves the autotune verdicts and captures
    # the graphs (not timed)
    ops.clear_autotune_cache()
    t0 = time.perf_counter()
    off = 0
    for qq in BUCKETS:
        at.search_jit(queries[off:off + qq], K)
        off += qq
    torch.cuda.synchronize()
    log(f"anytime: config {tuple(cfg)}; warm-up with the autotune sweeps "
        f"{time.perf_counter() - t0:.2f} s")
    for key, tuned in sorted(ops.autotune_cache().items(), key=str):
        times = " ".join(f"{name}={us:.1f}" for name, us in tuned.timings_us)
        log(f"anytime: autotune {key} -> {tuned.impl}@{tuned.tile_n}; "
            f"timings_us {times}")
    lists = engine.index.lists
    rng = np.random.default_rng(args.seed + 6)
    mask = torch.as_tensor(rng.random((lists.nlist, lists.cap)) < 0.5,
                           device=lists.ids.device) & (lists.ids >= 0)
    fbits = pack_filter_mask(mask)

    zero_counts()
    lat: dict[int, list[float]] = {qq: [] for qq in BUCKETS}
    kept, rec_ids, rec_gt = {}, [], []
    pruned = skipped = 0
    for _ in range(BATCHES_PER_BUCKET):
        for qq in BUCKETS:
            q = queries[off:off + qq]
            t0 = time.perf_counter()
            res = at.search_jit(q, K)
            torch.cuda.synchronize()
            lat[qq].append((time.perf_counter() - t0) * 1e3)
            check_result(torch, res.dists, res.ids, qq, n, f"anytime Q={qq}")
            pruned += int(res.stats.lists_pruned.sum())
            skipped += int(res.stats.tiles_skipped.sum())
            if qq == 32 and "plain" not in kept:
                kept["plain"] = (off, None, res)
            if qq == BUCKETS[-1]:
                rec_ids.append(res.ids)
                rec_gt.append(ds.gt_ids[off:off + qq])
            off += qq
    q32 = queries[off:off + 32]
    t0 = time.perf_counter()
    res = at.search_jit(q32, K, filter_bits=fbits)
    torch.cuda.synchronize()
    filt_ms = (time.perf_counter() - t0) * 1e3
    kept["filtered"] = (off, fbits, res)
    if int(res.stats.rows_filtered.sum()) <= 0:
        raise AssertionError("anytime: filtered batch excluded no row")
    # every scan kernel on an engine path, whatever the verdicts were
    forced = {}
    for impl in ("select", "mxu", "stream"):
        r = with_cfg(scan_impl=impl).search_jit(q32, K)
        check_result(torch, r.dists, r.ids, 32, n,
                     f"anytime scan_impl={impl}")
        forced[impl] = r
    stream_eng = with_cfg(scan_impl="stream")
    probes = stream_eng.select_probes(q32, AT_NPROBE)
    dists, ids = stream_eng.scan(q32, probes)
    torch.cuda.synchronize()
    launches = {name: mod.launches for name, mod in kernel_modules().items()}
    log(f"anytime: kernel launches on the path {launches}")
    for name in ("fastscan_stream_grouped", "fastscan_stream_topk_prune",
                 "fastscan_select_grouped", "fastscan_onehot_mma_grouped"):
        if launches[name] < 1:
            raise AssertionError(f"anytime: {name} was not launched")
    if ids.shape != (32, AT_NPROBE * lists.cap):
        raise AssertionError(f"anytime: SearchEngine.scan pool {ids.shape}")
    for impl in ("select", "mxu"):
        a, b = forced[impl], forced["stream"]
        if not (torch.equal(a.ids, b.ids) and torch.equal(a.dists, b.dists)):
            raise AssertionError(f"anytime: scan_impl={impl} != stream")
    log(f"anytime: forced scan_impl select / mxu / stream+early_exit agree "
        f"bitwise; stream skipped "
        f"{int(forced['stream'].stats.tiles_skipped.sum())} tiles at Q=32")

    # lossless: early exit against none, and margin_tau=inf against 'fixed'
    ee = with_cfg(scan_impl="stream", rerank_impl="stream")
    no_ee = with_cfg(scan_impl="stream", rerank_impl="stream",
                     early_exit=False)
    fixed = with_cfg(scan_impl="stream", rerank_impl="stream",
                     probe_policy="fixed", early_exit=False)
    lossless_skips = 0
    for qq in BUCKETS:
        q = queries[:qq]
        for tau in (AT_TAU, float("inf")):
            a = ee.search_jit(q, K, margin_tau=tau)
            b = no_ee.search_jit(q, K, margin_tau=tau)
            if not (torch.equal(a.ids, b.ids) and torch.equal(a.dists,
                                                               b.dists)):
                raise AssertionError(f"anytime: early exit is lossy at "
                                     f"Q={qq}, tau={tau}")
            lossless_skips += int(a.stats.tiles_skipped.sum())
        c = fixed.search_jit(q, K)
        if not (torch.equal(a.ids, c.ids) and torch.equal(a.dists, c.dists)
                and not a.stats.lists_pruned.any()):
            raise AssertionError(f"anytime: margin_tau=inf != fixed at "
                                 f"Q={qq}")
    log(f"anytime: early exit lossless (bitwise, {lossless_skips} tiles "
        "skipped) and margin_tau=inf bitwise equal to 'fixed' at every "
        "bucket")

    # the host replays the card's verdicts from a saved autotune file
    ops.save_autotune_cache(tuned_file)
    with open(tuned_file) as f:
        saved = json.load(f)
    for e in saved["entries"]:
        e["backend"] = "cpu"
    with open(tuned_file, "w") as f:
        json.dump(saved, f)
    ops.load_autotune_cache(tuned_file)
    host_twin_check(torch, engine, cfg, kept, queries, "anytime")

    ids = torch.cat(rec_ids)
    gt = torch.cat(rec_gt)
    r1 = float(recall_at_r(ids, gt, 1))
    r10 = float(recall_at_r(ids, gt, 10))
    log(f"anytime: recall@1 {r1:.4f} recall@10 {r10:.4f} over "
        f"{ids.shape[0]} queries; lists_pruned {pruned}, tiles_skipped "
        f"{skipped} over the timed batches")
    for qq in BUCKETS:
        v = lat[qq]
        med = sorted(v)[len(v) // 2]
        log(f"anytime: Q={qq} batch latency ms (host clock, synchronized): "
            f"{' '.join(f'{x:.3f}' for x in v)}; QPS at the median "
            f"{qq / (med / 1e3):.1f}")
        wall, dev_ms, n_kern, rows = breakdown(
            torch, lambda: at.search_jit(queries[:qq], K))
        # the work behind the profiled batch: on a stream verdict, K4's
        # scanned steps are the probed lists' tiles less those skipped
        st = at.search_jit(queries[:qq], K).stats
        n_tiles = lists.cap // ops._stream_tile(lists.cap)
        log(f"anytime: Q={qq} profiled query set: lists_probed "
            f"{int(st.lists_probed.sum())}, lists_pruned "
            f"{int(st.lists_pruned.sum())}, tiles_skipped "
            f"{int(st.tiles_skipped.sum())}; stream steps scanned "
            f"{int(st.lists_probed.sum()) * n_tiles - int(st.tiles_skipped.sum())}")
        log(f"anytime: Q={qq} profiled batch: device busy {dev_ms:.4f} ms in "
            f"{n_kern} device ops = {100 * dev_ms / med:.1f}% of the median "
            f"unprofiled latency {med:.3f} ms (idle "
            f"{100 * (1 - dev_ms / med):.1f}%); profiled wall {wall:.3f} ms")
        for name, ms in rows[:6]:
            log(f"    {ms:.4f} ms  {name[:90]}")
    log(f"anytime: Q=32 filtered batch {filt_ms:.3f} ms")
    return launches


def same_result(torch, a, b) -> bool:
    """Bitwise: dists, ids and all seven QueryStats fields."""
    return (torch.equal(a.dists, b.dists) and torch.equal(a.ids, b.ids)
            and all(torch.equal(x, y) for x, y in zip(a.stats, b.stats)))


def pin_verdicts(path: str, cap: int, nlist: int, n: int) -> int:
    """Write a v3 autotune file that fixes the anytime path's verdicts, so
    its graph-phase figures repeat: per bucket the scan at probe_fill 0.5
    (`select@1024` at Q = 1, the verdict most earlier sweeps gave at G = 32,
    with its second resolve at 1.0; `stream@1024` above, the tile K4 runs
    fastest at) and the re-rank (`stream`, K2 at its default tile)."""
    from repro_torch.kernels import ops
    entries = []
    for qq in BUCKETS:
        g = qq * AT_NPROBE
        impl = "select" if qq == 1 else "stream"
        for fill in ((0.5, 1.0) if impl == "select" else (0.5,)):
            entries.append({"kind": "scan", "backend": "cuda",
                            "interpret": False, "g": g, "cap": cap, "m": M,
                            "nlist": nlist, "probe_fill": fill, "impl": impl,
                            "tile_n": 1024, "timings_us": []})
        entries.append({"kind": "rerank", "backend": "cuda",
                        "interpret": False, "q": qq, "r": RERANK_MULT * K,
                        "d": 128, "k": K, "n": n, "impl": "stream",
                        "tile_n": ops._rerank_tile(RERANK_MULT * K),
                        "timings_us": []})
    with open(path, "w") as f:
        json.dump({"schema": "repro.autotune/v3", "entries": entries}, f)
    return len(entries)


def graph_phase(torch, args, engine, ds, what: str, cfg,
                members=None) -> dict:
    """``search_jit`` (one CUDA graph replay a batch) against ``search``
    (eager) on one IVF path, on a fresh engine over ``engine``'s index:
    bit for bit at every bucket, for a filtered Q=32 batch, a per-query
    tau batch (margin policy) and, given a namespace table ``members``, a
    namespaced Q=32 batch (held against the host pipeline too, and
    isolated); the cache counts under steady traffic and new values; then
    both timed in turns per bucket. Returns this path's launch counts."""
    from repro_torch.core.lists import pack_filter_mask
    from repro_torch.engine import SearchEngine, fused_cache_size
    gc.collect()
    queries = ds.queries
    lists = engine.index.lists
    dev = lists.ids.device
    eng = SearchEngine(engine.index, base=engine.base,
                       base_norms=engine.base_norms, config=cfg,
                       namespaces=members)
    margin = cfg.probe_policy == "margin"
    rng = np.random.default_rng(args.seed + 11)
    n_ns = 0 if members is None else members.shape[0]

    def request(i: int) -> dict:
        """Distinct filter, tenants (a quarter -1) and tau for one Q=32
        batch."""
        mask = torch.as_tensor(rng.random(tuple(lists.ids.shape)) < 0.5,
                               device=dev) & (lists.ids >= 0)
        out = {"filter_bits": pack_filter_mask(mask)}
        if n_ns:
            ns = rng.integers(0, n_ns, 32).astype(np.int32)
            ns[rng.permutation(32)[:8]] = -1
            out["namespaces"] = torch.as_tensor(ns, device=dev)
        if margin:
            out["margin_tau"] = torch.as_tensor(
                rng.uniform(0.1, 0.6, 32), dtype=torch.float32, device=dev)
        return out

    def both(q, **kw):
        got, want = eng.search_jit(q, K, **kw), eng.search(q, K, **kw)
        if not same_result(torch, got, want):
            raise AssertionError(f"{what} graph: search_jit != search at "
                                 f"Q={q.shape[0]} {sorted(kw)}")
        return got

    torch.cuda.synchronize()
    torch.cuda.empty_cache()      # reserved memory = live blocks + pools
    alloc0, res0 = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    torch.cuda.reset_peak_memory_stats()
    n0 = fused_cache_size()
    zero_counts()
    # first call of each key: warm-up, capture, replay; all == eager
    q32 = queries[:32]
    for qq in BUCKETS:
        both(queries[:qq])
    req = request(0)
    batches = [("filter_bits",)]
    if margin:
        batches.append(("margin_tau",))
    if n_ns:
        batches.append(("namespaces",))
    for names in batches:
        res = both(q32, **{k: req[k] for k in names})
        if names == ("namespaces",):
            ns_res, ns_vec = res, req["namespaces"]
    keys = len(BUCKETS) + len(batches)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    graphs_n = fused_cache_size() - n0
    alloc1, res1 = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    peak = torch.cuda.max_memory_allocated()
    if graphs_n != keys or len(eng.graphs) != keys:
        raise AssertionError(f"{what} graph: {graphs_n} graphs for {keys} "
                             "keys")
    # steady traffic and new values at seen keys capture nothing
    for _ in range(3):
        for qq in BUCKETS:
            both(queries[:qq])
    for i in range(1, 4):
        req = request(i)
        for names in batches:
            both(q32, **{k: req[k] for k in names})
    if fused_cache_size() - n0 != keys:
        raise AssertionError(f"{what} graph: steady traffic or new values "
                             "captured a graph")
    log(f"{what} graph: search_jit == search bit for bit (dists, ids, 7 "
        f"QueryStats) at Q in {BUCKETS} and Q=32 with "
        f"{', '.join(n for names in batches for n in names)}, 4 rounds and "
        f"4 values each; fused_cache_size +{graphs_n} for {keys} keys, +0 "
        "for 3 more rounds and 3 new values at each key")
    caps = sorted(eng.graphs.capture_seconds().items(), key=str)
    for key, sec in caps:
        log(f"{what} graph: capture (warm-up + capture) {sec * 1e3:.1f} ms "
            f"for Q={key[0][0]} optional shapes {key[2]}")
    log(f"{what} graph: {keys} graphs; memory_allocated +{alloc1 - alloc0} "
        f"B (static inputs and outputs, the capture stream's cuBLAS "
        f"workspace), memory_reserved +{res1 - res0} B (with the graphs' "
        f"pool; both after empty_cache), max_memory_allocated {peak} B over "
        "the captures")
    if n_ns:
        ns_check(torch, eng, cfg, ns_res, q32, ns_vec, what)
    launches = {name: mod.launches for name, mod in kernel_modules().items()}
    log(f"{what} graph: kernel launches (replays counted) {launches}")

    # where the graph call's host time goes (cProfile adds its own cost
    # to every Python call, so only the shares are read)
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(50):
        eng.search_jit(q32, K)
    prof.disable()
    torch.cuda.synchronize()
    stats = pstats.Stats(prof)
    total = stats.total_tt
    rows = sorted(stats.stats.items(), key=lambda kv: -kv[1][2])[:12]
    log(f"{what} graph: host profile of 50 search_jit calls at Q=32 "
        f"(cProfile, {total * 1e3 / 50:.3f} ms a call under it), own time "
        "a call: " + "; ".join(
            f"{fn[2]} ({os.path.basename(fn[0])}:{fn[1]}) "
            f"{v[2] * 1e3 / 50:.4f} ms" for fn, v in rows))

    # eager and graph in turns, per bucket
    for qq in BUCKETS:
        q = queries[:qq]
        lat = {"eager": [], "graph": []}
        call = {"eager": [], "graph": []}
        fns = {"eager": lambda: eng.search(q, K),
               "graph": lambda: eng.search_jit(q, K)}
        for rnd in range(GRAPH_ROUNDS):
            for name in (("eager", "graph") if rnd % 2 == 0
                         else ("graph", "eager")):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fns[name]()
                t1 = time.perf_counter()
                torch.cuda.synchronize()
                call[name].append((t1 - t0) * 1e3)
                lat[name].append((time.perf_counter() - t0) * 1e3)
        ev = []
        for _ in range(5):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fns["graph"]()
            end.record()
            end.synchronize()
            ev.append(start.elapsed_time(end))
        busy = {}
        for name in ("eager", "graph"):
            _, dev_ms, n_ops, rows = breakdown(torch, fns[name])
            busy[name] = (dev_ms, n_ops)
        for name in ("eager", "graph"):
            med = float(np.median(lat[name]))
            dev_ms, n_ops = busy[name]
            log(f"{what} graph: Q={qq} {name}: latency ms (host clock, "
                f"synchronized) {' '.join(f'{x:.3f}' for x in lat[name])}; "
                f"median {med:.3f}, QPS {qq / (med / 1e3):.1f}; call "
                f"without synchronize median "
                f"{float(np.median(call[name])):.3f} ms; device busy "
                f"{dev_ms:.4f} ms in {n_ops} device ops (profiler), idle "
                f"{100 * (1 - dev_ms / med):.1f}%")
        log(f"{what} graph: Q={qq} replay CUDA-event time ms "
            f"{' '.join(f'{x:.4f}' for x in ev)}; eager busy "
            f"{busy['eager'][0]:.4f} ms is "
            f"{100 * busy['eager'][0] / float(np.median(lat['graph'])):.1f}% "
            "of the graph median")
    return launches


def ns_check(torch, eng, cfg, res, q, ns, what: str) -> None:
    """The namespaced Q=32 batch against the host pipeline on CPU copies
    (ids tie-aware, dists rtol PIPELINE_RTOL, QueryStats exact), and
    isolation: every id lies in a list its tenant owns."""
    from repro_torch import interop
    t0 = time.perf_counter()
    host = interop.engine_from_arrays(interop.arrays_from_engine(eng),
                                      config=cfg, device="cpu")
    want = host.search(q.cpu(), K, namespaces=ns.cpu())
    wv, wi = want.dists.numpy(), want.ids.numpy()
    tol = PIPELINE_RTOL * np.abs(wv).max(axis=1)
    assert_tie_aware(res.dists.cpu().numpy(), res.ids.cpu().numpy(), wv, wi,
                     tol, f"{what} namespaced card vs host")
    for f in want.stats._fields:
        if not np.array_equal(getattr(res.stats, f).cpu().numpy(),
                              getattr(want.stats, f).numpy()):
            raise AssertionError(f"{what} namespaced card vs host: "
                                 f"stats.{f}")
    lists = eng.index.lists
    owner = torch.full((eng.base.shape[0],), -1, dtype=torch.long,
                       device=lists.ids.device)
    li = torch.arange(lists.nlist, device=owner.device)[:, None].expand(
        lists.ids.shape)
    ok = lists.ids >= 0
    owner[lists.ids[ok].long()] = li[ok]
    restricted = ns >= 0
    got = res.ids[restricted].long()
    allowed = eng.ns_member[ns[restricted].long()]          # (R, nlist)
    inside = torch.gather(allowed, 1, owner[got.clamp_min(0)]) | (got < 0)
    if not bool(inside.all()):
        raise AssertionError(f"{what} namespaced: a query left its tenant")
    log(f"{what} namespaced: Q=32 batch ({int(restricted.sum())} queries in "
        f"{int(eng.ns_member.shape[0])} tenants, the rest -1) equals the "
        f"host pipeline (ids tie-aware, QueryStats exact) and every id lies "
        f"in its tenant's lists [{time.perf_counter() - t0:.1f} s]")


def flat_kernel_phases(torch, args, index, queries) -> list[dict]:
    """K7a, K7b and K7c against their plain versions: timed at the flat
    path's largest bucket (Q=128 real query LUTs x the index's N codes,
    M=16; K7c's padded with 0xFF to its 1024-row block as ``ops`` pads
    them) and at its smallest two (Q=1 and 8), then untimed through
    ``ops`` at Q=32 with M=8 and M=32, with a {0, 1} LUT (ties
    everywhere), and K7c at block 100 on N=1500."""
    from repro_torch.core import fastscan as fs
    from repro_torch.core import pq
    from repro_torch.kernels import blockmin_kernel as bk
    from repro_torch.kernels import mxu_flat_kernel as mfk
    from repro_torch.kernels import ops
    from repro_torch.kernels import select_flat_kernel as sfk
    from repro_torch.kernels.fastscan_kernel import TILE_N
    dev = torch.device("cuda")
    qq, n = AT_QMAX, index.n
    table = fs.quantize_lut(pq.adc_table(index.codebook,
                                         queries[:qq])).table_q8.contiguous()
    codes = index.packed_codes.contiguous()
    mh = codes.shape[1]
    out = []

    def plain():
        return sfk.fastscan_distances_plain(table, codes)

    want = plain()
    # bytes: the LUTs and codes read once, the (Q, N) sums written once
    nbytes = qq * M * 16 + n * mh + qq * n * 4
    ops_count = qq * n * M * 2
    # mmas: the one-hot product's m16n8k32 MMAs, one a (8 queries, 16 rows,
    # code byte)
    for name, fn, dev_name, src, line, what, mmas in (
            ("fastscan_select_flat", sfk.fastscan_select_tree,
             "select_flat_kernel", "fastscan_select_flat.cu", 128, "K7a",
             None),
            ("fastscan_onehot_mma_flat", mfk.fastscan_onehot_mxu,
             "onehot_mma_flat_kernel", "fastscan_onehot_mma_flat.cu", 211,
             "K7b", -(-qq // 8) * -(-n // 16) * mh)):
        def kernel(fn=fn):
            return fn(table, codes)

        assert_same((kernel(),), (want,), what)
        log(f"{what} {name}: Q={qq} N={n} M={M}: kernel == plain bit for "
            f"bit")
        out.append(time_kernel(
            torch, kernel, plain, dev_name, nbytes, ops_count, what,
            name=name, source=f"src/repro_torch/kernels/csrc/{src}",
            replaces=f"src/repro/kernels/fastscan_kernel.py:{line}",
            mmas=mmas))
    del want
    # a yardstick, not a port: the card filling the same (Q, N) i32 output
    out_q = torch.empty((qq, n), dtype=torch.int32, device=dev)
    fill_ms = event_ms(torch, lambda: out_q.fill_(1), 20)
    log(f"store floor: torch fill_ of the ({qq}, {n}) i32 output, "
        f"{qq * n * 4} B: events {fill_ms:.5f} ms")
    del out_q
    block = TILE_N
    codes_ff = ops._pad_to(index.packed_codes, 0, block, value=0xFF
                           ).contiguous()
    n_ff = codes_ff.shape[0]
    # the flat path's small buckets: K7b (the 'mxu' default) beside K7a,
    # and K7c
    for qs in (1, 8):
        t_s = table[:qs].contiguous()
        want_s = sfk.fastscan_distances_plain(t_s, codes)
        bound, by = bound_ms(qs * M * 16 + n * mh + qs * n * 4,
                             qs * n * M * 2)
        for fn, dev_name, what in (
                (mfk.fastscan_onehot_mxu, "onehot_mma_flat_kernel", "K7b"),
                (sfk.fastscan_select_tree, "select_flat_kernel", "K7a")):
            def small(fn=fn):
                return fn(t_s, codes)

            assert_same((small(),), (want_s,), f"{what} Q={qs}")
            ms_ev = event_ms(torch, small, 20)
            ms_dev = device_ms(torch, small, dev_name, 10)
            log(f"{what} at Q={qs} N={n} M={M}: kernel == plain bit for bit; "
                f"device {ms_dev} ms, events {ms_ev:.5f} ms, bound "
                f"{bound:.6f} ms ({by})")
        del want_s

        def small_k7c():
            return bk.fastscan_blockmin(t_s, codes_ff, tile_n=block)

        assert_same(small_k7c(), bk.fastscan_blockmin_plain(
            t_s, codes_ff, tile_n=block), f"K7c Q={qs}")
        bound, by = bound_ms(
            qs * M * 16 + n_ff * mh + 2 * qs * (n_ff // block) * 4,
            qs * n_ff * M * 2)
        ms_ev = event_ms(torch, small_k7c, 20)
        ms_dev = device_ms(torch, small_k7c, "blockmin_kernel", 10)
        log(f"K7c at Q={qs} N={n_ff} M={M} block={block}: mins and ids == "
            f"plain bit for bit; device {ms_dev} ms, events {ms_ev:.5f} ms, "
            f"bound {bound:.6f} ms ({by})")

    def k7c():
        return bk.fastscan_blockmin(table, codes_ff, tile_n=block)

    def k7c_plain():
        return bk.fastscan_blockmin_plain(table, codes_ff, tile_n=block)

    assert_same(k7c(), k7c_plain(), "K7c")
    log(f"K7c fastscan_blockmin: Q={qq} N={n_ff} (0xFF-padded) "
        f"M={M} block={block}: mins and ids == plain bit for bit")
    out.append(time_kernel(
        torch, k7c, k7c_plain, "blockmin_kernel",
        qq * M * 16 + n_ff * mh + 2 * qq * (n_ff // block) * 4,
        qq * n_ff * M * 2, "K7c", name="fastscan_blockmin",
        source="src/repro_torch/kernels/csrc/fastscan_blockmin.cu",
        replaces="src/repro/kernels/fastscan_kernel.py:311",
        mmas=-(-qq // 8) * -(-n_ff // 16) * mh))

    # untimed: other widths, ties, a block that is no multiple of 8
    rng = np.random.default_rng(args.seed + 7)
    for m, levels, nn, block in ((8, 256, 100_000, 1024),
                                 (32, 256, 100_000, 1024),
                                 (16, 2, 100_000, 1000),
                                 (8, 256, 1500, 100)):
        t = torch.as_tensor(rng.integers(0, levels, (32, m, 16), np.uint8),
                            device=dev)
        c = torch.as_tensor(rng.integers(0, 256, (nn, m // 2), np.uint8),
                            device=dev)
        ref = ops.fastscan_distances(t, c, impl="ref")
        for impl in ("select", "mxu"):
            assert_same((ops.fastscan_distances(t, c, impl=impl),), (ref,),
                        f"ops {impl} M={m} levels={levels}")
        padded = ops._pad_to(c, 0, block, value=0xFF)
        assert_same(ops.fastscan_blockmin(t, c, block=block),
                    bk.fastscan_blockmin_plain(t, padded, tile_n=block),
                    f"ops blockmin M={m} block={block}")
    torch.cuda.synchronize()
    log("K7a/K7b/K7c through ops at Q=32, M in {8, 32}, a {0, 1} LUT "
        "(ties) and block 100 on N=1500: kernel == plain bit for bit")
    return out


def flat_phase(torch, args, ds, index) -> dict:
    """The third path: the flat fast-scan index (K7b 'mxu', K7a 'select')
    and the naive-PQ baseline on the same codes, every bucket, in rotated
    order, then one ``ops.fastscan_blockmin`` (K7c); returns the launch
    counts of this path."""
    from repro_torch import interop
    from repro_torch.core import fastscan as fs
    from repro_torch.core import pq
    from repro_torch.core.metrics import recall_at_r
    from repro_torch.kernels import ops
    n = index.n
    queries = ds.queries
    naive_codes = fs.unpack_codes(index.packed_codes)   # (N, M) for naive PQ
    methods = {
        "mxu": lambda q: fs.search(index, q, topk=K, impl="mxu"),
        "select": lambda q: fs.search(index, q, topk=K, impl="select"),
        "naive": lambda q: pq.search(index.codebook, naive_codes, q, topk=K)}
    names = list(methods)
    off = 0
    for qq in BUCKETS:              # warm-up of every bucket, not timed
        for fn in methods.values():
            fn(queries[off:off + qq])
        off += qq
    torch.cuda.synchronize()

    zero_counts()
    lat = {(name, qq): [] for name in names for qq in BUCKETS}
    got_ids = {name: [] for name in names}
    gt, kept = [], None
    for rep in range(BATCHES_PER_BUCKET):
        for qq in BUCKETS:
            q = queries[off:off + qq]
            res = {}
            for name in names[rep % 3:] + names[:rep % 3]:
                t0 = time.perf_counter()
                res[name] = methods[name](q)
                torch.cuda.synchronize()
                lat[(name, qq)].append((time.perf_counter() - t0) * 1e3)
                check_result(torch, *res[name], qq, n, f"flat {name}")
                got_ids[name].append(res[name][1])
            if not (torch.equal(res["select"][0], res["mxu"][0])
                    and torch.equal(res["select"][1], res["mxu"][1])):
                raise AssertionError(f"flat: select != mxu at Q={qq}")
            gt.append(ds.gt_ids[off:off + qq])
            if qq == 32 and kept is None:
                kept = (off, res["mxu"])
            off += qq
    q128 = queries[:AT_QMAX]
    qlut = fs.quantize_lut(pq.adc_table(index.codebook, q128))
    mins, bids = ops.fastscan_blockmin(qlut.table_q8, index.packed_codes,
                                       block=1024)
    torch.cuda.synchronize()
    launches = {name: mod.launches for name, mod in kernel_modules().items()}
    log(f"flat: kernel launches on the path {launches}")
    for name in ("fastscan_select_flat", "fastscan_onehot_mma_flat",
                 "fastscan_blockmin"):
        if launches[name] < 1:
            raise AssertionError(f"flat: {name} was not launched")

    gt = torch.cat(gt)
    rec = {name: (float(recall_at_r(torch.cat(ids), gt, 1)),
                  float(recall_at_r(torch.cat(ids), gt, 10)))
           for name, ids in got_ids.items()}
    gap = abs(rec["mxu"][1] - rec["naive"][1])
    log(f"flat: recall@1/@10 over {gt.shape[0]} queries: "
        + "; ".join(f"{name} {r1:.4f}/{r10:.4f}"
                    for name, (r1, r10) in rec.items())
        + f"; |recall@10 fast - naive| = {gap:.4f} (limit {FIG2_GAP})")
    if gap >= FIG2_GAP:
        raise AssertionError(f"flat: Fig. 2 parity gap {gap} >= {FIG2_GAP}")
    log("flat: select == mxu bitwise (dists and ids) in every timed batch")

    # the block minima against the scan's sums of the same LUTs
    acc = ops.fastscan_distances(qlut.table_q8, index.packed_codes,
                                 impl="mxu")
    nbf = n // 1024
    full = acc[:, :nbf * 1024].reshape(AT_QMAX, nbf, 1024)
    first = torch.arange(nbf, device=bids.device) * 1024
    if not (torch.equal(mins[:, :nbf], full.amin(-1))
            and bool(((bids[:, :nbf] - first) // 1024 == 0).all())
            and bool((bids[:, :nbf] >= first).all())
            and torch.equal(acc.gather(1, bids[:, :nbf].long()),
                            mins[:, :nbf])):
        raise AssertionError("flat: block minima disagree with the scan")
    log(f"flat: ops.fastscan_blockmin at Q={AT_QMAX} over the {n} codes: "
        f"{tuple(mins.shape)} mins and ids; every full block's min equals "
        f"the scan's, its id lies in the block and reaches it; last block "
        f"ids >= N (padded rows): {int((bids[:, -1] >= n).sum())}")

    # per bucket: batch latency, and the scan stage alone
    for qq in BUCKETS:
        q = queries[:qq]
        tab = pq.adc_table(index.codebook, q)
        t8 = fs.quantize_lut(tab).table_q8
        scan = {"mxu": lambda: ops.fastscan_distances(t8, index.packed_codes,
                                                      impl="mxu"),
                "select": lambda: ops.fastscan_distances(
                    t8, index.packed_codes, impl="select"),
                "naive": lambda: pq.adc_lookup(tab, naive_codes)}
        scan_ms = {name: event_ms(torch, fn, 5, warmup=1)
                   for name, fn in scan.items()}
        parts = []
        for name in names:
            v = lat[(name, qq)]
            med = sorted(v)[len(v) // 2]
            parts.append(f"{name} {' '.join(f'{x:.3f}' for x in v)} med "
                         f"{med:.3f} / QPS {qq / (med / 1e3):.1f} / scan "
                         f"{scan_ms[name]:.4f}")
        log(f"flat: Q={qq} batch ms (host clock, synchronized) / QPS / scan "
            f"stage ms (CUDA events, mean of 5): " + "; ".join(parts)
            + f"; scan naive/mxu {scan_ms['naive'] / scan_ms['mxu']:.2f}x "
            f"naive/select {scan_ms['naive'] / scan_ms['select']:.2f}x")
    for name in names:
        med = sorted(lat[(name, AT_QMAX)])[BATCHES_PER_BUCKET // 2]
        wall, dev_ms, n_kern, rows = breakdown(
            torch, lambda: methods[name](q128))
        log(f"flat: {name} Q={AT_QMAX} profiled batch: device busy "
            f"{dev_ms:.4f} ms in {n_kern} device ops = "
            f"{100 * dev_ms / med:.1f}% of the median {med:.3f} ms (idle "
            f"{100 * (1 - dev_ms / med):.1f}%); profiled wall {wall:.3f} ms")
        for op, ms in rows[:5]:
            log(f"    {ms:.4f} ms  {op[:90]}")

    # the kept Q=32 batch through the port on a CPU copy of the index
    t0 = time.perf_counter()
    o, (gv, gi) = kept
    q = queries[o:o + 32]
    host = interop.fastscan_index_from_arrays(
        interop.arrays_from_fastscan_index(index), device="cpu")
    hl = fs.quantize_lut(pq.adc_table(host.codebook, q.cpu()))
    cl = fs.quantize_lut(pq.adc_table(index.codebook, q))
    flips = (cl.table_q8.cpu() != hl.table_q8).sum(dim=(1, 2)).numpy()
    wv, wi = fs.search(host, q.cpu(), topk=K, impl="mxu")
    wv, wi = wv.numpy(), wi.numpy()
    # an f32 LUT entry that rounds to the other u8 moves a sum by one step
    tol = PIPELINE_RTOL * np.abs(wv).max(axis=1) + flips * hl.scale.numpy()
    assert_tie_aware(gv.cpu().numpy(), gi.cpu().numpy(), wv, wi, tol,
                     "flat card vs host")
    log(f"flat: Q=32 batch equals the host pipeline (ids tie-aware, dists "
        f"rtol {PIPELINE_RTOL} plus one quantization step for each of the "
        f"{int(flips.sum())} u8 LUT entries that rounded the other way) "
        f"[{time.perf_counter() - t0:.1f} s]")
    return launches


MUT_BATCH = 1000              # rows a mutation batch
MUT_NEW, MUT_DELETE, MUT_REUPSERT = 10_000, 10_000, 2_000
MUT_CAP = 5120                # 5 x 1024: spare slots, 1024-row scan tiles


def sift_rows(torch, args, n: int, d: int, dev):
    """New rows from the dataset's generator (``make_sift_like`` with the
    data's seed: the same clusters, other draws), rounded to integers as
    SIFT descriptors are: a row's distance to itself is then exactly 0 in
    any summation order."""
    from repro_torch.data.vectors import make_sift_like
    rows = make_sift_like(n=n, nt=1, nq=1, d=d, seed=args.seed,
                          device=dev).base
    return torch.round(rows)


def encoder_check(torch, engine, base) -> None:
    """How many build-time codes differ from ``encode_rows``' for the same
    rows (the build encodes through it, so none may), and how many a GEMM
    at the reference's 65,536-row build chunks would assign or encode
    otherwise (the batch-shape effect the fixed-shape encoder removes)."""
    from repro_torch.core import fastscan as fs
    from repro_torch.core import pq
    from repro_torch.core.ivf import encode_rows
    from repro_torch.core.kmeans import pairwise_sqdist
    idx = engine.index
    t0 = time.perf_counter()
    assign, packed = encode_rows(idx.centroids, idx.codebook, base)
    enc_s = time.perf_counter() - t0
    ids = idx.lists.ids.cpu().numpy()
    ls, ss = np.nonzero(ids >= 0)
    g = ids[ls, ss]
    codes = idx.lists.codes.cpu().numpy()[ls, ss]
    differ = int(((assign[g] != ls) | (packed[g] != codes).any(1)).sum())
    gemm_a, gemm_p = [], []
    with torch.no_grad():
        for s in range(0, base.shape[0], 65536):
            x = base[s:s + 65536]
            a = torch.argmin(pairwise_sqdist(x, idx.centroids), dim=-1)
            gemm_a.append(a)
            gemm_p.append(fs.pack_codes(pq.encode(idx.codebook,
                                                  x - idx.centroids[a])))
    gemm_a = torch.cat(gemm_a).cpu().numpy()
    gemm_p = torch.cat(gemm_p).cpu().numpy()
    moved = int((gemm_a != assign).sum())
    recoded = int(((gemm_a == assign) & (gemm_p != packed).any(1)).sum())
    log(f"mutation: encode_rows over the {base.shape[0]} base rows "
        f"{enc_s:.2f} s; build-time codes that differ from encode_rows': "
        f"{differ}; a GEMM at 65536-row chunks (the reference's build) "
        f"assigns {moved} rows to another list and encodes {recoded} more "
        f"otherwise")
    if differ:
        raise AssertionError(f"mutation: {differ} build-time codes differ "
                             "from encode_rows'")


def mutation_phase(torch, args, engine, ds) -> dict:
    """Live mutation on the stream path's configuration, on an engine of
    its own over the stream engine's index (its first write clones the
    store and base, so the stream engine's stay as they were, which is
    checked at the end): compact to MUT_CAP, then
    MUT_NEW new ids, MUT_DELETE deletes and MUT_REUPSERT re-upserts in
    batches of MUT_BATCH, then compact. After each batch: search_jit ==
    search bit for bit, no deleted id returned, each upserted row found
    first at distance 0 by its own vector, the graph count unchanged on
    shape-keeping batches. At the end: the store equals a rebuild from its
    own codes laid out in write order, the two engines' results are equal
    on the stream and the gathered path, and recall against exact ground
    truth over the survivors. Returns the path's launch counts."""
    from repro_torch.core.lists import build_lists
    from repro_torch.core.metrics import intersection_recall
    from repro_torch.data.vectors import exact_ground_truth
    from repro_torch.engine import SearchEngine, fused_cache_size
    idx = engine.index
    lists = idx.lists
    cfg = engine.config
    encoder_check(torch, engine, ds.base)
    ids_given = lists.ids.clone()
    mut = SearchEngine(idx, base=engine.base, base_norms=engine.base_norms,
                       config=cfg)
    n = engine.base.shape[0]
    nlist = lists.nlist
    dev = engine.device
    q32 = ds.queries[:32].contiguous()

    def synced(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    _, loc_s = synced(lambda: mut.locate(0))       # built on first use
    _, compact0 = synced(lambda: mut.compact(cap=MUT_CAP))
    log(f"mutation: the locator over {n} rows built in {loc_s * 1e3:.1f} "
        f"ms; compact to cap {MUT_CAP} (from {lists.cap}) {compact0:.3f} "
        f"s; spare slots a list >= {MUT_CAP - int(lists.sizes.max())}")
    q_other = ds.queries[32:64].contiguous()

    def recall(what):
        """Intersection recall@K of search_jit against exact ground truth
        over the live rows, for the check queries (their true neighbours
        are the first rows deleted) and for 32 others."""
        live = torch.as_tensor(np.nonzero(alive)[0], device=dev)
        out = []
        for qs in (q32, q_other):
            gt = live[exact_ground_truth(mut.base[live], qs, g=K).long()]
            out.append(float(intersection_recall(
                mut.search_jit(qs, K).ids.long(), gt)))
        log(f"mutation: intersection recall@{K} {what} over "
            f"{int(alive.sum())} live rows: {out[0]:.4f} (the check "
            f"queries), {out[1]:.4f} (32 others)")

    def latency(what):
        _, first = synced(lambda: mut.search_jit(q32, K))
        steady = sorted(synced(lambda: mut.search_jit(q32, K))[1]
                        for _ in range(9))
        log(f"mutation: Q=32 search_jit {what}: first call "
            f"{first * 1e3:.3f} ms, steady median {steady[4] * 1e3:.3f} ms "
            f"(of 9, host clock + synchronize)")
    latency("before mutation")

    # host model: which gids live, in what order they were written, where
    n_max = n + MUT_NEW
    alive = np.zeros(n_max, bool)
    alive[:n] = True
    seq = np.zeros(n_max, np.int64)
    seq[:n] = np.arange(n)           # the build lays each list in id order
    list_of = np.full(n_max, -1, np.int64)
    ids0 = mut.index.lists.ids.cpu().numpy()
    l0, _ = np.nonzero(ids0 >= 0)
    list_of[ids0[ids0 >= 0]] = l0
    written = [n]
    dead_dev = torch.zeros(n_max, dtype=torch.bool, device=dev)
    recall("before mutation")

    def check(what, fresh_key=False, vecs=None, gids=None):
        jit = mut.search_jit(q32, K)
        eager = mut.search(q32, K)
        if not same_result(torch, jit, eager):
            raise AssertionError(f"mutation {what}: search_jit != search")
        got = jit.ids[jit.ids >= 0].long()
        if bool(dead_dev[got].any()):
            raise AssertionError(f"mutation {what}: a deleted id came back")
        if vecs is not None:
            hit = mut.search_jit(vecs[:32], K)
            want = torch.as_tensor(gids[:32], device=dev)
            if not (torch.equal(hit.ids[:, 0].long(), want)
                    and bool((hit.dists[:, 0] == 0).all())):
                raise AssertionError(f"mutation {what}: an upserted row is "
                                     "not first at distance 0")

    gc.collect()
    rng = np.random.default_rng(args.seed + 11)
    zero_counts()
    drops0 = mut.graphs_dropped
    rows = sift_rows(torch, args, MUT_NEW + MUT_REUPSERT,
                     engine.base.shape[1], dev)
    new_rows, re_rows = rows[:MUT_NEW], rows[MUT_NEW:]
    ups, recaptures = [], []
    for b in range(MUT_NEW // MUT_BATCH):      # new ids: the base grows
        gids = np.arange(n + b * MUT_BATCH, n + (b + 1) * MUT_BATCH)
        vecs = new_rows[b * MUT_BATCH:(b + 1) * MUT_BATCH]
        assign, dt = synced(lambda: mut.upsert(gids, vecs))
        ups.append(MUT_BATCH / dt)
        # the graphs were dropped with the old base: this call captures
        recaptures.append(synced(lambda: mut.search_jit(q32, K))[1] * 1e3)
        alive[gids] = True
        seq[gids] = written[0] + np.arange(gids.size)
        written[0] += gids.size
        list_of[gids] = assign
        check(f"upsert {b}", vecs=vecs, gids=gids)
    gc.collect()
    graphs0, size0 = len(mut.graphs), fused_cache_size()
    dels = []
    # the check queries' true neighbours die first, so a stale result shows
    first = np.unique(ds.gt_ids[:32].cpu().numpy().ravel())
    pool = rng.permutation(np.setdiff1d(np.arange(n), first))
    order = np.concatenate([first, pool])[:MUT_DELETE]
    for b in range(MUT_DELETE // MUT_BATCH):
        gids = order[b * MUT_BATCH:(b + 1) * MUT_BATCH]
        got, dt = synced(lambda: mut.delete(gids))
        if got != gids.size:
            raise AssertionError(f"mutation: delete {b} removed {got}")
        dels.append(dt * 1e3)
        alive[gids] = False
        dead_dev[torch.as_tensor(gids, device=dev)] = True
        check(f"delete {b}")
        if b == 0:
            graphs1, size1 = len(mut.graphs), fused_cache_size()
            log(f"mutation: the first delete added {graphs1 - graphs0} "
                f"graph(s), fused_cache_size {size0} -> {size1}")
            # one key in use (Q=32, k=10), now with the live-row bitmap
            # (none off the card, where search_jit captures nothing)
            added = int(dev.type == "cuda")
            if (graphs1 - graphs0, size1 - size0) != (added, added):
                raise AssertionError("mutation: the first delete should add "
                                     "exactly the live-bits key")
    live_old = rng.permutation(np.nonzero(alive[:n])[0])[:MUT_REUPSERT]
    reups = []
    for b in range(MUT_REUPSERT // MUT_BATCH):
        gids = live_old[b * MUT_BATCH:(b + 1) * MUT_BATCH]
        vecs = re_rows[b * MUT_BATCH:(b + 1) * MUT_BATCH]
        assign, dt = synced(lambda: mut.upsert(gids, vecs))
        reups.append(MUT_BATCH / dt)
        seq[gids] = written[0] + np.arange(gids.size)
        written[0] += gids.size
        list_of[gids] = assign
        check(f"re-upsert {b}", vecs=vecs, gids=gids)
    n_tomb = mut.n_tombstones
    reclaimed, compact1 = synced(lambda: mut.compact())
    if reclaimed != n_tomb or mut.index.lists.cap != MUT_CAP:
        raise AssertionError(f"mutation: compact reclaimed {reclaimed} of "
                             f"{n_tomb}, cap {mut.index.lists.cap}")
    check("compact")
    gc.collect()
    if (len(mut.graphs), fused_cache_size()) != (graphs1, size1):
        raise AssertionError(
            f"mutation: shape-keeping batches changed the graphs: "
            f"{graphs1} -> {len(mut.graphs)}, fused_cache_size {size1} -> "
            f"{fused_cache_size()}")
    launches = {name: mod.launches for name, mod in kernel_modules().items()}
    log("mutation: upsert rows/s by batch (new ids): "
        + " ".join(f"{x:.0f}" for x in ups))
    log("mutation: Q=32 search_jit first call after each new-id batch "
        "(a capture) ms: " + " ".join(f"{x:.3f}" for x in recaptures))
    log("mutation: delete ms by batch: " + " ".join(f"{x:.3f}" for x in dels))
    log("mutation: upsert rows/s by batch (re-upserts): "
        + " ".join(f"{x:.0f}" for x in reups))
    log(f"mutation: compact {compact1:.3f} s ({reclaimed} tombstones, cap "
        f"{MUT_CAP}); graphs dropped by reallocating batches "
        f"{mut.graphs_dropped - drops0}; graphs now {len(mut.graphs)}, "
        f"unchanged by {MUT_DELETE // MUT_BATCH - 1} deletes, "
        f"{MUT_REUPSERT // MUT_BATCH} re-upserts and the compaction; epoch "
        f"{mut.epoch}")
    latency("after mutation")

    # the rebuild: the store's own live rows, in write order
    st = mut.index.lists
    ids = st.ids.cpu().numpy()
    ls, ss = np.nonzero(ids >= 0)
    g = ids[ls, ss]
    if not np.array_equal(np.sort(g), np.nonzero(alive)[0]):
        raise AssertionError("mutation: the store's live ids are not the "
                             "model's")
    if not np.array_equal(list_of[g], ls):
        raise AssertionError("mutation: a row lies in another list than "
                             "it was routed to")
    for gid in rng.choice(g, 5, replace=False):
        j = int(np.nonzero(g == gid)[0][0])
        if mut.locate(int(gid)) != (int(ls[j]), int(ss[j])):
            raise AssertionError(f"mutation: locate({gid}) is wrong")
    by_write = np.argsort(seq[g], kind="stable")
    codes = st.codes.cpu().numpy()[ls, ss]
    rebuilt = build_lists(ls[by_write], codes[by_write], nlist=nlist,
                          cap=st.cap, ids=g[by_write], device=dev)
    for name in ("codes", "ids", "sizes"):
        if not torch.equal(getattr(rebuilt, name), getattr(st, name)):
            raise AssertionError(f"mutation: the store's {name} differ "
                                 "from the rebuild's")
    gathered = cfg._replace(scan_impl="select", rerank_impl="gathered")
    for what, c in (("stream", cfg), ("gathered", gathered)):
        a = SearchEngine(mut.index, base=mut.base, base_norms=mut.base_norms,
                         config=c)
        o = SearchEngine(mut.index._replace(lists=rebuilt), base=mut.base,
                         base_norms=mut.base_norms, config=c)
        for call in ("search", "search_jit"):
            ra, ro = getattr(a, call)(q32, K), getattr(o, call)(q32, K)
            if not same_result(torch, ra, ro):
                raise AssertionError(f"mutation: {what} {call} differs from "
                                     "the rebuild")
    log("mutation: the store equals a rebuild from its own codes in write "
        "order (codes, ids, sizes); search and search_jit equal the "
        "rebuild's on the stream (K1 + K2) and the gathered (K5 + "
        "gathered re-rank) path, bit for bit")
    launches_check = {name: mod.launches
                      for name, mod in kernel_modules().items()}
    need_launches(launches_check, ("fastscan_stream_topk",
                                   "rerank_stream_topk",
                                   "fastscan_select_grouped"), "mutation")
    recall("after mutation")
    if not (engine.index.lists is lists and torch.equal(lists.ids, ids_given)
            and engine.base.shape[0] == n and engine.live_bits is None):
        raise AssertionError("mutation: the stream engine's index changed "
                             "under the engine built over it")
    log("mutation: the stream engine's store is unchanged (the mutated "
        "engine's first write cloned it)")
    log(f"mutation: kernel launches on the path {launches_check}")
    return launches


# the coarse-zoo phase: the paper's Table 1 pipeline (benchmarks/table1.py:
# Deep1B-like data, nlist = sqrt(N), M = 16, K = 16, HNSW coarse with m = 16
# and ef_construction = 64, nprobe 1 to 8, rerank_mult 0 and 4)
T1_D, T1_NCL, T1_NOISE = 96, 4096, 1.0
T1_NQ = 512
T1_NPROBES, T1_RERANK = (1, 2, 4, 8), (0, 4)
T1_HNSW_M, T1_EF_C = 16, 64
T1_ITERS = 15                 # coarse and PQ k-means iterations (table1.py)
SHARDS = 4                    # the sharded phase's shards
SHARD_WRITES = 3              # batches of MUT_BATCH of each write kind


def rows_with_repeated_probe(torch, probes) -> int:
    """Rows of (Q, P) probes in which a valid probe repeats."""
    s = torch.sort(probes, dim=1).values
    dup = (s[:, 1:] == s[:, :-1]) & (s[:, 1:] >= 0)
    return int(dup.any(dim=1).sum())


def synced_s(torch, fn):
    """(fn(), seconds) on the host clock around work ended by a
    synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def coarse_phase(torch, args) -> dict:
    """The paper's Table 1 pipeline at full width: a Deep1B-like base (N x
    96, ``make_deep_like`` with table1.py's clusters and query noise),
    nlist = sqrt(N), M = 16, an HNSW coarse quantizer built by
    ``SearchEngine.build(coarse='hnsw')``, the stream scan (K1) and re-rank
    (K2); beside it a k-means-tree engine and a flat-coarse engine over the
    same index. At nprobe 1, 2, 4, 8 and rerank_mult 0 and 4: recall@1 and
    @10 of each quantizer through ``search_jit``, ``search_jit`` == ``search``
    bit for bit (HNSW and tree), no repeated probe in any query. Then the
    coarse stage's device time and device ops against flat coarse, each
    engine's graph busy time, and graph latency at each bucket. Returns the
    launch counts of the driven run."""
    from repro_torch.core import coarse as coarse_mod
    from repro_torch.core.lists import grow_cap
    from repro_torch.core.metrics import recall_at_r
    from repro_torch.data.vectors import make_deep_like
    from repro_torch.engine import EngineConfig, SearchEngine
    from repro_torch.engine.engine import coarse_probes
    from repro_torch.kernels.fastscan_kernel import TILE_N
    gc.collect()
    t0 = time.perf_counter()
    ds = make_deep_like(n=args.n, nt=args.nt, nq=T1_NQ, d=T1_D, ncl=T1_NCL,
                        query_noise=T1_NOISE, seed=args.seed, device=DEVICE)
    nlist = max(16, int(np.sqrt(args.n)))
    log(f"table1: data {args.n} x {T1_D} (Deep1B-like, {T1_NCL} clusters, "
        f"query noise {T1_NOISE}), {args.nt} train, {T1_NQ} queries with "
        f"exact ground truth [{time.perf_counter() - t0:.1f} s]")
    cfg = EngineConfig(nprobe=NPROBE, rerank_mult=RERANK_MULT,
                       scan_impl="stream", rerank_impl="stream")
    built, build_s = synced_s(torch, lambda: SearchEngine.build(
        ds.train, ds.base, m=M, nlist=nlist, coarse="hnsw", config=cfg,
        coarse_iters=T1_ITERS, pq_iters=T1_ITERS, seed=args.seed,
        device=DEVICE, hnsw_m=T1_HNSW_M, ef_construction=T1_EF_C))
    graph = built.coarse.graph
    again, hnsw_s = synced_s(torch, lambda: coarse_mod.build_hnsw_coarse(
        built.index.centroids, m=T1_HNSW_M, ef_construction=T1_EF_C))
    same = (again.graph.entry == graph.entry and all(
        torch.equal(a, b) for a, b in zip(again.graph.tensors(),
                                          graph.tensors())))
    if not same:
        raise AssertionError("table1: a second HNSW build over the same "
                             "centroids gave another graph")
    pads = int((graph.level0 < 0).any(dim=1).sum())
    log(f"table1: SearchEngine.build(coarse='hnsw', hnsw_m={T1_HNSW_M}, "
        f"ef_construction={T1_EF_C}) {build_s:.2f} s, of which the HNSW "
        f"build over the {nlist} centroids (numpy, host) {hnsw_s:.2f} s "
        f"(built twice: the same graph); levels above 0: "
        f"{[int(ids.shape[0]) for ids, _ in graph.uppers]} nodes; level-0 "
        f"rows with padding {pads} of {nlist}")
    raw_cap = built.index.cap
    cap = -(-raw_cap // TILE_N) * TILE_N
    index = built.index._replace(lists=grow_cap(built.index.lists, cap))

    def engine(coarse):
        return SearchEngine(index, base=built.base,
                            base_norms=built.base_norms, config=cfg,
                            coarse=coarse)
    engines = {"hnsw": engine(built.coarse), "flat": engine("flat")}
    engines["tree"], tree_s = synced_s(torch, lambda: engine("tree"))
    tree = engines["tree"].coarse
    kids = tree.children[tree.children >= 0]
    if not torch.equal(torch.sort(kids).values,
                       torch.arange(nlist, device=kids.device,
                                    dtype=kids.dtype)):
        raise AssertionError("table1: a centroid is not under exactly one "
                             "root")
    log(f"table1: index nlist={nlist} cap={cap} (largest list {raw_cap}); "
        f"tree: {tree.roots.shape[0]} roots, up to {tree.children.shape[1]} "
        f"children, built in {tree_s:.2f} s")

    q_all, gt = ds.queries, ds.gt_ids
    zero_counts()
    recall = {}
    for nprobe in T1_NPROBES:
        for rr in T1_RERANK:
            for name in ("hnsw", "tree", "flat"):
                eng = engines[name]
                ids = []
                for off in range(0, T1_NQ, 128):
                    q = q_all[off:off + 128]
                    res = eng.search_jit(q, K, nprobe=nprobe,
                                         rerank_mult=rr)
                    check_result(torch, res.dists, res.ids, q.shape[0],
                                 args.n, f"table1 {name} nprobe={nprobe}")
                    if off == 0 and name != "flat":
                        eager = eng.search(q, K, nprobe=nprobe,
                                           rerank_mult=rr)
                        if not same_result(torch, res, eager):
                            raise AssertionError(
                                f"table1 {name}: search_jit != search at "
                                f"nprobe={nprobe} rerank_mult={rr}")
                    ids.append(res.ids)
                ids = torch.cat(ids)
                recall[(name, nprobe, rr)] = (
                    float(recall_at_r(ids, gt, 1)),
                    float(recall_at_r(ids, gt, 10)))
    launches = {name: mod.launches for name, mod in kernel_modules().items()}
    log(f"table1: kernel launches (replays counted) {launches}")
    need_launches(launches, ("fastscan_stream_topk", "rerank_stream_topk"),
                  "table1")
    log(f"table1: search_jit == search bit for bit (dists, ids, 7 "
        f"QueryStats) for the HNSW and tree engines at nprobe "
        f"{T1_NPROBES} x rerank_mult {T1_RERANK}")
    for rr in T1_RERANK:
        for name in ("hnsw", "tree", "flat"):
            log(f"table1: {name} rerank_mult={rr} recall@1 / recall@10 by "
                f"nprobe {T1_NPROBES}: " + "  ".join(
                    f"{recall[(name, p, rr)][0]:.4f} / "
                    f"{recall[(name, p, rr)][1]:.4f}" for p in T1_NPROBES))
    # routing: distinct probes, and how many of flat's probes each finds
    for nprobe in T1_NPROBES:
        _, flat_p = engines["flat"].coarse.search(q_all, nprobe)
        parts = []
        for name in ("hnsw", "tree"):
            probes = engines[name].select_probes(q_all, nprobe)
            dups = rows_with_repeated_probe(torch, probes)
            if dups:
                raise AssertionError(f"table1 {name}: {dups} queries hold a "
                                     f"repeated probe at nprobe={nprobe}")
            hit = (probes[:, :, None] == flat_p[:, None, :]).any(-1)
            parts.append(f"{name} {float(hit.float().mean()):.4f} "
                         f"({int((probes < 0).sum())} empty)")
        log(f"table1: nprobe={nprobe}: no repeated probe in {T1_NQ} "
            f"queries; share of flat coarse's probes found: "
            + ", ".join(parts))
    # the coarse stage against the rest of the query
    for qq in (32, 128):
        q = q_all[:qq]
        for name in ("flat", "hnsw", "tree"):
            eng = engines[name]
            _, c_ms, c_ops, _ = breakdown(torch, lambda: coarse_probes(
                eng.coarse, q, nprobe=NPROBE, ef=cfg.ef))
            eng.search_jit(q, K)
            _, g_ms, g_ops, _ = breakdown(torch,
                                          lambda: eng.search_jit(q, K))
            log(f"table1: Q={qq} {name} coarse stage (eager): device "
                f"{c_ms:.4f} ms in {c_ops} device ops; the whole query as "
                f"a graph: device {g_ms:.4f} ms in {g_ops} device ops "
                f"(coarse {100 * c_ms / g_ms:.1f}% of it)")
    for name in ("hnsw", "tree", "flat"):
        eng = engines[name]
        meds = []
        for qq in BUCKETS:
            q = q_all[:qq]
            eng.search_jit(q, K)
            lat = sorted(synced_s(torch, lambda: eng.search_jit(q, K))[1]
                         * 1e3 for _ in range(7))
            meds.append(lat[3])
        log(f"table1: {name} search_jit latency ms at Q {BUCKETS} (median "
            f"of 7, host clock + synchronize, nprobe={NPROBE}, "
            f"rerank_mult={RERANK_MULT}): "
            + " ".join(f"{x:.3f}" for x in meds))
    return launches


def sharded_phase(torch, args, engine, ds) -> dict:
    """``ShardedEngine(engine, SHARDS)`` over the stream path's index,
    shards in turn on this card (one card: the ``torch.distributed`` path
    needs one a rank and runs in the CPU tests only). Against the
    single-host engine: one shard tie-aware within 1e-6 x (||q||^2 + max
    ||x||^2); every list probed without re-rank, the same rows scanned, so
    tie-aware within PIPELINE_RTOL; at nprobe 8 each returned distance is
    its row's exact distance, recall@10 at least the single-host engine's,
    and the stats the sums over the shards. Then a write program through
    the shards and the single-host engine alike (compact to MUT_CAP,
    SHARD_WRITES batches each of new ids, deletes and re-upserts, compact),
    held after it and after the compaction: no deleted id back, upserted
    rows first at distance 0, the single-host engine with every list
    probed, and the single-host engine sharded afresh. Returns the launch
    counts of the driven run."""
    from repro_torch.core.kmeans import pairwise_sqdist
    from repro_torch.core.metrics import recall_at_r
    from repro_torch.core.topk import smallest_k
    from repro_torch.engine import SearchEngine, ShardedEngine
    gc.collect()
    sh, part_s = synced_s(torch, lambda: ShardedEngine(engine, SHARDS))
    nl = sh.lists_s.nlist
    nlist = engine.index.lists.nlist
    q = ds.queries[:128].contiguous()
    gt = ds.gt_ids[:128]
    x_max = float(engine.base_norms.max())
    k2_tol = (1e-6 * ((q * q).sum(1) + x_max)).cpu().numpy()
    log(f"sharded: ShardedEngine(engine, {SHARDS}) {part_s:.2f} s "
        f"(partition on the card: {nl} lists a shard, base slices of "
        f"{sh.base_s.shape[1]} rows, rows a shard {list(sh._state.rows_used)})"
        "; shards run in turn on one card (the torch.distributed path "
        "needs a card a rank)")

    def host(t):
        return t.cpu().numpy()

    def exact_check(res, what):
        """Each returned distance is its row's true distance."""
        ids = res.ids.long()
        if (host(ids) < 0).any():
            raise AssertionError(f"sharded {what}: an empty result slot")
        want = []
        for j in range(0, q.shape[0], 32):
            diff = (engine.base[ids[j:j + 32]].double()
                    - q[j:j + 32, None].double())
            want.append((diff * diff).sum(-1))
        want = host(torch.cat(want))
        err = np.abs(host(res.dists).astype(np.float64) - want)
        if (err > k2_tol[:, None]).any():
            raise AssertionError(f"sharded {what}: a distance is off its "
                                 f"row's by {err.max()}")

    def vs(got, want, tol, what):
        assert_tie_aware(host(got.dists), host(got.ids), host(want.dists),
                         host(want.ids), tol, what)

    zero_counts()
    res = sh.search(q, K)
    single = engine.search(q, K)
    exact_check(res, "nprobe 8")
    r_sh = float(recall_at_r(res.ids, gt, 10))
    r_single = float(recall_at_r(single.ids, gt, 10))
    if r_sh < r_single:
        raise AssertionError(f"sharded: recall@10 {r_sh} below the "
                             f"single-host engine's {r_single}")
    # the stats, summed over the shards, from each shard's own probes
    codes = torch.zeros(q.shape[0], dtype=torch.int64, device=q.device)
    for j in range(SHARDS):
        _, p = smallest_k(pairwise_sqdist(q, sh.centroids_s[j]), NPROBE)
        codes += sh.lists_s.sizes[j][p.long()].sum(1)
    if not (torch.equal(res.stats.codes_scanned.long(), codes)
            and bool((res.stats.lists_probed == SHARDS * NPROBE).all())
            and bool((res.stats.reranked
                      == SHARDS * RERANK_MULT * K).all())):
        raise AssertionError("sharded: stats are not the shards' sums")
    one = ShardedEngine(engine, 1).search(q, K)
    vs(one, single, k2_tol, "one shard vs the single-host engine")
    every = sh.search(q[:32], K, nprobe=nl, rerank_mult=0)
    every1 = engine.search(q[:32], K, nprobe=nlist, rerank_mult=0)
    tol = PIPELINE_RTOL * np.abs(host(every1.dists)).max(axis=1)
    vs(every, every1, tol, "every list probed, no re-rank")
    log(f"sharded: at nprobe {NPROBE} each shard's, recall@10 {r_sh:.4f} "
        f"(single-host {r_single:.4f}), every distance its row's exact one "
        f"within 1e-6 x (||q||^2 + max ||x||^2), stats the shards' sums "
        f"(lists_probed {SHARDS * NPROBE}, reranked "
        f"{SHARDS * RERANK_MULT * K}); one shard == the single-host engine "
        f"(ids tie-aware, that tolerance); every list probed without "
        f"re-rank == the single-host engine (ids tie-aware, dists rtol "
        f"{PIPELINE_RTOL})")
    lat = {}
    for qq in BUCKETS:
        qb = ds.queries[:qq].contiguous()
        sh.search(qb, K)
        ts = sorted(synced_s(torch, lambda: sh.search(qb, K))[1] * 1e3
                    for _ in range(7))
        lat[qq] = ts[3]
    _, busy, n_ops, _ = breakdown(torch, lambda: sh.search(q[:32], K))
    log(f"sharded: batch latency ms at Q {BUCKETS} (eager, shards in turn, "
        f"median of 7, host clock + synchronize): "
        + " ".join(f"{lat[qq]:.3f}" for qq in BUCKETS)
        + f"; Q=32 device busy {busy:.4f} ms in {n_ops} device ops, idle "
        f"{100 * (1 - busy / lat[32]):.1f}%")

    # the write program, through the shards and the single-host engine
    mut = SearchEngine(engine.index, base=engine.base,
                       base_norms=engine.base_norms, config=engine.config)
    n = engine.base.shape[0]
    _, c0 = synced_s(torch, lambda: sh.compact(cap=MUT_CAP))
    mut.compact(cap=MUT_CAP)
    rows = sift_rows(torch, args, 2 * SHARD_WRITES * MUT_BATCH,
                     engine.base.shape[1], q.device)
    rng = np.random.default_rng(args.seed + 21)
    times = {"upsert": [], "delete": [], "reupsert": []}
    dead = np.unique(host(ds.gt_ids[:32]).ravel())
    dead = np.concatenate([dead, rng.permutation(
        np.setdiff1d(np.arange(n), dead))])[:SHARD_WRITES * MUT_BATCH]
    fresh = np.arange(n, n + SHARD_WRITES * MUT_BATCH)
    moved = rng.permutation(np.setdiff1d(np.arange(n), dead))[
        :SHARD_WRITES * MUT_BATCH]
    for b in range(SHARD_WRITES):
        at = slice(b * MUT_BATCH, (b + 1) * MUT_BATCH)
        a, dt = synced_s(torch, lambda: sh.upsert(fresh[at], rows[at]))
        if not np.array_equal(a, mut.upsert(fresh[at], rows[at])):
            raise AssertionError("sharded: an upsert routed a row to "
                                 "another list than the single-host engine")
        times["upsert"].append(MUT_BATCH / dt)
        got, dt = synced_s(torch, lambda: sh.delete(dead[at]))
        if got != MUT_BATCH or mut.delete(dead[at]) != MUT_BATCH:
            raise AssertionError("sharded: a delete missed rows")
        times["delete"].append(dt * 1e3)
        vecs = rows[SHARD_WRITES * MUT_BATCH:][at]
        _, dt = synced_s(torch, lambda: sh.upsert(moved[at], vecs))
        mut.upsert(moved[at], vecs)
        times["reupsert"].append(MUT_BATCH / dt)
    if sh.n_tombstones != 2 * SHARD_WRITES * MUT_BATCH:
        raise AssertionError(f"sharded: {sh.n_tombstones} tombstones")
    dead_dev = torch.zeros(n + fresh.size, dtype=torch.bool,
                           device=q.device)
    dead_dev[torch.as_tensor(dead, device=q.device)] = True

    def held(what):
        got = sh.search(q, K)
        if bool(dead_dev[got.ids[got.ids >= 0].long()].any()):
            raise AssertionError(f"sharded {what}: a deleted id came back")
        oracle = ShardedEngine(mut, SHARDS).search(q, K)
        vs(got, oracle, k2_tol, f"{what}: vs the single-host engine "
                                "sharded afresh")
        every = sh.search(q[:32], K, nprobe=nl, rerank_mult=0)
        every1 = mut.search(q[:32], K, nprobe=nlist, rerank_mult=0)
        vs(every, every1,
           PIPELINE_RTOL * np.abs(host(every1.dists)).max(axis=1),
           f"{what}: every list probed, no re-rank")
        for vecs, gids in ((rows[:32], fresh[:32]),
                           (rows[SHARD_WRITES * MUT_BATCH:][:32],
                            moved[:32])):
            hit = sh.search(vecs, K)
            if not (np.array_equal(host(hit.ids[:, 0]), gids)
                    and bool((hit.dists[:, 0] == 0).all())):
                raise AssertionError(f"sharded {what}: an upserted row is "
                                     "not first at distance 0")
    held("after the writes")
    _, c1 = synced_s(torch, lambda: sh.compact())
    mut.compact()
    if sh.n_tombstones or sh.live_s is not None:
        raise AssertionError("sharded: compaction left tombstones")
    held("after compaction")
    launches = {name: mod.launches for name, mod in kernel_modules().items()}
    log(f"sharded: kernel launches on the path {launches}")
    need_launches(launches, ("fastscan_stream_topk", "rerank_stream_topk"),
                  "sharded")
    log(f"sharded: writes through {SHARDS} shards, batches of {MUT_BATCH}: "
        f"upsert rows/s (new ids) "
        + " ".join(f"{x:.0f}" for x in times["upsert"])
        + "; delete ms " + " ".join(f"{x:.3f}" for x in times["delete"])
        + "; re-upsert rows/s "
        + " ".join(f"{x:.0f}" for x in times["reupsert"])
        + f"; compact to cap {MUT_CAP} {c0:.3f} s, after the writes "
        f"{c1:.3f} s; results held after the writes and after compaction "
        "(no deleted id, upserted rows first at distance 0, == the "
        "single-host engine with every list probed, == it sharded afresh)")
    return launches


SERVE_CONCURRENCY = (1, 8, 32, 128)   # closed-loop client threads
SERVE_S = 2.0                 # seconds of reads at each concurrency
SERVE_WAIT_S = 0.0005         # the batcher's window for co-riders
SERVE_WRITES = 8              # MUT_BATCH-row writes under reads
FAILOVER_WRITES = 4           # MUT_BATCH-row writes on the primary
SERVE_FIELDS = ("lists_probed", "codes_scanned", "reranked", "rows_filtered",
                "rows_tombstoned", "lists_pruned", "tiles_skipped")


class Clients:
    """Closed-loop client threads against a serving loop: each submits one
    pool query, waits for it, and submits the next, until ``stop`` is set.
    Keeps (query row, ServeResult, submit time, done time) of every
    request and the repr of every failed one."""

    def __init__(self, loop, pool: np.ndarray, threads: int, seed: int):
        import threading
        self.loop, self.pool = loop, pool
        self.stop = threading.Event()
        self.served, self.failed = [], []
        self._lock = threading.Lock()
        self._threads = [threading.Thread(target=self._run,
                                          args=(seed * 1000 + t,))
                         for t in range(threads)]

    def _run(self, seed: int) -> None:
        rng = np.random.default_rng(seed)
        served, failed = [], []
        while not self.stop.is_set():
            qi = int(rng.integers(self.pool.shape[0]))
            t0 = time.monotonic()
            try:
                res = self.loop.submit(self.pool[qi], k=K).result(timeout=60)
            except Exception as e:  # counted: the phase fails on any
                failed.append(repr(e))
                continue
            served.append((qi, res, t0, time.monotonic()))
        with self._lock:
            self.served += served
            self.failed += failed

    def __enter__(self) -> "Clients":
        for t in self._threads:
            t.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop.set()
        for t in self._threads:
            t.join()


def held_to_search(served, want, tol, what: str) -> int:
    """Each served row against the eager ``search`` of its query: equal, or
    tie-aware within ``tol`` (a differing row not at a tie fails); every
    stat exact. Returns the rows that differ at a tie."""
    qi = np.array([s[0] for s in served])
    gd = np.stack([s[1].dists for s in served])
    gi = np.stack([s[1].ids for s in served])
    wd, wi = want["dists"][qi], want["ids"][qi]
    tied = np.nonzero(~((gd == wd).all(1) & (gi == wi).all(1)))[0]
    for r in tied:
        assert_tie_aware(gd[r:r + 1], gi[r:r + 1], wd[r:r + 1], wi[r:r + 1],
                         tol[qi[r]:qi[r] + 1], what)
    for f in SERVE_FIELDS:
        got = np.array([getattr(s[1], f) for s in served])
        if not np.array_equal(got, want[f][qi]):
            raise AssertionError(f"{what}: served {f} differ from search")
    return len(tied)


def same_engine_state(torch, a, b, what: str) -> None:
    """Two engines hold the same store, base, norms, live bits and
    counters, bit for bit."""
    la, lb = a.index.lists, b.index.lists
    pairs = [(x, y) for x, y in zip(la, lb)] + [
        (a.base, b.base), (a.base_norms, b.base_norms),
        (a.live_bits, b.live_bits)]
    for x, y in pairs:
        if (x is None) != (y is None) or (
                x is not None and not torch.equal(x, y)):
            raise AssertionError(f"{what}: the engines' state differs")
    if (a.epoch, a.n_tombstones) != (b.epoch, b.n_tombstones):
        raise AssertionError(f"{what}: epoch/tombstones differ")


def same_search(torch, a, b, q, what: str) -> None:
    ra, rb = a.search(q, K), b.search(q, K)
    for x, y in zip((ra.dists, ra.ids, *ra.stats),
                    (rb.dists, rb.ids, *rb.stats)):
        if not torch.equal(x, y):
            raise AssertionError(f"{what}: search results differ")


def serving_phase(torch, args, engine, ds, root: str) -> dict:
    """Durable serving on the stream configuration (``repro_torch.serving``
    and ``repro_torch.persist``), on an engine of its own over the stream
    engine's index, compacted to MUT_CAP first. Boots a ``ServingLoop``
    with a snapshot directory (a full snapshot and a WAL) and warms every
    bucket; closed-loop clients at each SERVE_CONCURRENCY, every served row
    held against ``search`` (tie-aware, stats exact) and no graph captured
    or verdict swept after warm-up; then reads at 32 clients under
    1,000-row writes with the WAL fsync'd and two forced delta checkpoints;
    recovery with ``persist.open_engine`` (state and results bit for bit);
    a primary and a standby loop over a ``DirTransport`` with writes, a
    promotion, the acknowledged prefix held and the old primary fenced;
    and ``tools/crash_test_torch.py`` once a drill. Returns the launch
    counts of the loop's dispatches."""
    import shutil
    from repro_torch import persist
    from repro_torch.engine import SearchEngine
    from repro_torch.persist import snapshot as snap_mod
    from repro_torch.serving import ServingLoop
    gc.collect()
    work = os.path.join(root, "build", "chip_smoke_serving")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    sdir = os.path.join(work, "primary")
    dev = engine.device
    n = engine.base.shape[0]
    srv = SearchEngine(engine.index, base=engine.base,
                       base_norms=engine.base_norms, config=engine.config)
    srv.compact(cap=MUT_CAP)
    pool = ds.queries.cpu().numpy()
    new_rows = sift_rows(torch, args, MUT_BATCH * (SERVE_WRITES + 8), 128,
                         dev)
    next_id = [n]

    def rows_new():
        ids = np.arange(next_id[0], next_id[0] + MUT_BATCH)
        next_id[0] += MUT_BATCH
        return ids, new_rows[ids - n]

    zero_counts()
    # boot: durable (a full snapshot + the WAL), then one graph a bucket
    t0 = time.perf_counter()
    loop = ServingLoop(srv, snapshot_dir=sdir, snapshot_every=3600.0,
                       max_wait_s=SERVE_WAIT_S)
    boot_s = time.perf_counter() - t0
    d0 = persist.read_manifest(sdir)["delta"]
    t0 = time.perf_counter()
    loop.start(warmup=True)
    warm_s = time.perf_counter() - t0
    caps = {key[0][0]: s for key, s in srv.graphs.capture_seconds().items()}
    m_warm = loop.metrics()
    log(f"serving: durable boot {boot_s:.2f} s (full snapshot: "
        f"{d0['bytes_written']} bytes in {d0['segments_written']} segments, "
        f"capture under the lock {d0['capture_s'] * 1e3:.3f} ms); warm-up "
        f"{warm_s:.2f} s, {len(srv.graphs)} graphs, {m_warm.compiles} "
        "captures; capture ms a bucket "
        + ", ".join(f"Q={b}: {caps[b] * 1e3:.1f}" for b in sorted(caps)))
    if m_warm.compiles != len(BUCKETS) or len(srv.graphs) != len(BUCKETS):
        raise AssertionError(f"serving: warm-up captured {m_warm.compiles} "
                             f"graphs, not one a bucket")

    # steady reads, every served row held against search
    res = srv.search(ds.queries, K)
    want = {"dists": res.dists.cpu().numpy(), "ids": res.ids.cpu().numpy()}
    want.update({f: getattr(res.stats, f).cpu().numpy()
                 for f in SERVE_FIELDS})
    tol = PIPELINE_RTOL * np.abs(want["dists"]).max(axis=1)
    # the dispatch thread's host time: a whole batch, and search_jit in it
    timed = {"dispatch": [], "search_jit": []}

    def timing(fn, what):
        def run(*a, **kw):
            t = time.perf_counter()
            out = fn(*a, **kw)
            timed[what].append(time.perf_counter() - t)
            return out
        return run
    loop._dispatch = timing(loop._dispatch, "dispatch")
    srv.search_jit = timing(srv.search_jit, "search_jit")
    for c in SERVE_CONCURRENCY:
        for v in timed.values():
            v.clear()
        m0 = loop.metrics()
        with Clients(loop, pool, c, seed=c) as cl:
            time.sleep(SERVE_S)
        m1 = loop.metrics()
        if cl.failed:
            raise AssertionError(f"serving c={c}: {len(cl.failed)} failed "
                                 f"futures, e.g. {cl.failed[0]}")
        lat = np.array([s[1].latency_s for s in cl.served]) * 1e3
        rows = m1.rows_served - m0.rows_served
        pad = m1.rows_padded - m0.rows_padded
        bc = {b: m1.bucket_counts.get(b, 0) - m0.bucket_counts.get(b, 0)
              for b in BUCKETS}
        tied = held_to_search(cl.served, want, tol, f"serving c={c}")
        disp = np.array(timed["dispatch"]) * 1e3
        call = np.array(timed["search_jit"]) * 1e3
        log(f"serving: c={c}: {len(cl.served) / SERVE_S:.1f} QPS, "
            f"latency p50 {np.percentile(lat, 50):.3f} ms p99 "
            f"{np.percentile(lat, 99):.3f} ms, occupancy "
            f"{rows / max(1, rows + pad):.3f}, buckets {bc}; a batch on the "
            f"dispatch thread {np.median(disp):.3f} ms median (search_jit "
            f"call {np.median(call):.3f}), {len(disp) / SERVE_S:.0f} "
            f"batches/s; {len(cl.served)} rows held against search, {tied} "
            "differ at a tie")
    m_steady = loop.metrics()
    if (m_steady.compiles, m_steady.autotuned) != (m_warm.compiles,
                                                   m_warm.autotuned):
        raise AssertionError(
            f"serving: steady reads captured {m_steady.compiles - m_warm.compiles}"
            f" graphs and swept {m_steady.autotuned - m_warm.autotuned} "
            "verdicts after warm-up")

    # reads under writes, with two forced (delta) checkpoints
    import threading
    del loop._dispatch, srv.search_jit
    ckpts, live = [], np.arange(n)
    writes = {"new ids": [], "re-upsert": [], "delete": []}
    rng = np.random.default_rng(args.seed + 23)

    plan = []                       # drawn before the clients start
    for i in range(SERVE_WRITES):
        if i % 4 == 1:
            gids = rng.choice(live, MUT_BATCH, replace=False)
            plan.append(("delete", gids, None))
            live = np.setdiff1d(live, gids)
        elif i % 4 == 3:            # re-upsert live ids with new vectors
            gids = rng.choice(live, MUT_BATCH, replace=False)
            plan.append(("re-upsert", gids, new_rows[
                (gids % new_rows.shape[0]).astype(np.int64)]))
        else:                       # new ids: the base grows
            plan.append(("new ids", *rows_new()))
            live = np.concatenate([live, plan[-1][1]])

    def writer():
        for kind, gids, vecs in plan:
            t = time.monotonic()
            if vecs is None:
                loop.delete(gids)
            else:
                loop.upsert(gids, vecs)
            writes[kind].append((t, time.monotonic()))
            time.sleep(0.1)

    def checkpointer():
        for _ in range(2):
            time.sleep(0.6)
            t = time.monotonic()
            loop.checkpoint()
            ckpts.append((t, time.monotonic(),
                          persist.read_manifest(sdir)))

    from repro_torch.persist import io as pio
    appends, real_append = [], pio.append_record

    def timed_append(f, data):
        t = time.perf_counter()
        real_append(f, data)
        appends.append(time.perf_counter() - t)
    pio.append_record = timed_append
    m0 = loop.metrics()
    threads = [threading.Thread(target=writer),
               threading.Thread(target=checkpointer)]
    with Clients(loop, pool, 32, seed=99) as cl:
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    m1 = loop.metrics()
    pio.append_record = real_append
    if cl.failed or loop.checkpoint_error is not None:
        raise AssertionError(f"serving under writes: {len(cl.failed)} failed "
                             f"futures, checkpoint error "
                             f"{loop.checkpoint_error!r}")
    if m1.checkpoints - m0.checkpoints != 2 or any(
            c[2]["parent"] is None for c in ckpts):
        raise AssertionError("serving: the two forced checkpoints were not "
                             "both written as deltas")
    def overlaps(spans):
        return np.array([any(s[2] < e and s[3] > b for b, e in spans)
                         for s in cl.served], bool)
    in_ckpt = overlaps([(b, e) for b, e, _ in ckpts])
    in_write = overlaps([w for v in writes.values() for w in v])
    lat = np.array([s[3] - s[2] for s in cl.served]) * 1e3

    def p99(mask):
        return (f"{np.percentile(lat[mask], 99):.3f} ms ({int(mask.sum())} "
                "reads)" if mask.any() else "no reads")
    # the stall a capture puts on the stream: device time of its clones
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with srv._mutate_lock:
        start.record()
        tensors, _ = snap_mod._capture_single(srv)
        end.record()
    end.synchronize()
    clone_bytes = sum(t.numel() * t.element_size() for t in tensors.values()
                      if t is not None)
    del tensors
    rates = "; ".join(
        f"{kind} " + " ".join(f"{MUT_BATCH / (e - b):.0f}" for b, e in v)
        + " rows/s" for kind, v in writes.items() if kind != "delete")
    log(f"serving under writes: {len(cl.served)} reads at c=32, p99 with "
        f"neither a write nor a checkpoint running {p99(~in_ckpt & ~in_write)}"
        f", with a checkpoint and no write {p99(in_ckpt & ~in_write)}, with "
        f"a write {p99(in_write)}; max {lat.max():.3f} ms; {MUT_BATCH}-row "
        f"writes with the WAL fsync'd: {rates}; delete "
        + " ".join(f"{(e - b) * 1e3:.2f}" for b, e in writes["delete"])
        + f" ms; the WAL appends of records and file headers (write + fsync) "
        + " ".join(f"{t * 1e3:.1f}" for t in appends)
        + f" ms; captures after reallocating writes "
        f"{m1.compiles - m0.compiles}")
    for b, e, man in ckpts:
        dl = man["delta"]
        log(f"serving: checkpoint {man['snapshot']} (parent {man['parent']})"
            f" {e - b:.2f} s: {dl['bytes_written']} bytes written, "
            f"{dl['bytes_reused']} reused ({dl['segments_written']} / "
            f"{dl['segments_reused']} segments), lock held "
            f"{dl['capture_s'] * 1e3:.3f} ms")
    log(f"serving: a checkpoint's capture clones {clone_bytes} bytes on the "
        f"card in {start.elapsed_time(end):.3f} ms of device time (the "
        "stall it queues ahead of searches)")

    # recovery: close, two writes only the WAL holds, reopen on the card
    loop.close()
    ids, vecs = rows_new()
    gone = rng.choice(live, MUT_BATCH, replace=False)
    live = np.setdiff1d(live, gone)
    (_, up_s), (_, del_s) = (synced_s(torch, lambda: srv.upsert(ids, vecs)),
                             synced_s(torch, lambda: srv.delete(gone)))
    srv._wal.close()
    srv.attach_wal(None)
    t0 = time.perf_counter()
    prim, info = persist.open_engine(sdir, device=dev)
    torch.cuda.synchronize()
    log(f"serving: recovery (persist.open_engine on the card) "
        f"{time.perf_counter() - t0:.2f} s: snapshot {info.snapshot}, "
        f"wal_seq {info.wal_seq}, {info.replayed} records replayed, torn "
        f"tail {info.truncated_bytes} bytes; the two writes it replayed, "
        f"made with the WAL and no reader: upsert of new ids "
        f"{MUT_BATCH / up_s:.0f} rows/s, delete {del_s * 1e3:.2f} ms")
    if info.replayed != 2:
        raise AssertionError(f"serving: recovery replayed {info.replayed} "
                             "records, not 2")
    same_engine_state(torch, prim, srv, "recovery")
    same_search(torch, prim, srv, ds.queries[:128], "recovery")
    del srv, loop
    gc.collect()

    # failover: a primary loop and a standby loop from its snapshot
    start_seq = persist.save_snapshot(prim, sdir)["wal_seq"]
    stb, _ = persist.load_snapshot(sdir, device=dev)
    tdir = os.path.join(work, "ship")
    pl = ServingLoop(prim, snapshot_dir=sdir, snapshot_every=3600.0,
                     transport=persist.DirTransport(tdir), ship_every=0.02,
                     max_wait_s=SERVE_WAIT_S).start(warmup=True)
    sl = ServingLoop(stb, role="standby", snapshot_dir=os.path.join(
        work, "standby"), transport=persist.DirTransport(tdir),
        poll_every=0.01, standby_start_seq=start_seq,
        max_wait_s=SERVE_WAIT_S).start(warmup=True)
    lags, catch_up, write_s = [], [], []
    plan = [rng.choice(live, MUT_BATCH, replace=False) if i % 2
            else rows_new() for i in range(FAILOVER_WRITES)]
    with Clients(sl, pool, 8, seed=7) as cl:
        for i, w in enumerate(plan):
            t_w = time.monotonic()
            if i % 2:
                pl.delete(w)
            else:
                pl.upsert(*w)
            write_s.append(time.monotonic() - t_w)
            t_w = time.monotonic()
            while sl._replica.applied_seq < prim._wal.last_seq:
                lags.append(sl.replication_lag())
                if time.monotonic() - t_w > 60.0:
                    raise AssertionError(
                        f"failover: the standby applied "
                        f"{sl._replica.applied_seq} of {prim._wal.last_seq}"
                        f" records in 60 s (standby error "
                        f"{sl.replication_error!r}, primary error "
                        f"{pl.replication_error!r}, segments "
                        f"{sl.transport.list_segments()})")
                time.sleep(0.002)
            catch_up.append(time.monotonic() - t_w)
        acked = sl._replica.applied_seq
        same_search(torch, stb, prim, ds.queries[:128],
                    "failover: standby vs primary")
        acked_res = stb.search(ds.queries[:128], K)
        pl.stop()
        prim.upsert(*rows_new())    # logged by the primary, never shipped
        t0 = time.perf_counter()
        term = sl.promote()
        failover_s = time.perf_counter() - t0
        time.sleep(0.2)             # reads go on after the promotion
    if cl.failed:
        raise AssertionError(f"failover: {len(cl.failed)} failed standby "
                             f"reads, e.g. {cl.failed[0]}")
    got = stb.search(ds.queries[:128], K)
    for x, y in zip((got.dists, got.ids, *got.stats),
                    (acked_res.dists, acked_res.ids, *acked_res.stats)):
        if not torch.equal(x, y):
            raise AssertionError("failover: the promoted engine is not the "
                                 "acknowledged prefix")
    fenced = 0
    for act in (lambda: prim.delete(live[:3]), pl._shipper.ship_once):
        try:
            act()
        except persist.FencedError:
            fenced += 1
    if fenced != 2:
        raise AssertionError("failover: the deposed primary was not fenced "
                             "on both its append and its ship")
    sl.upsert(*rows_new())
    ms = sl.metrics()
    log(f"failover: {MUT_BATCH}-row writes on the primary "
        + " ".join(f"{t * 1e3:.1f}" for t in write_s) + " ms; the standby "
        "applied each in " + " ".join(f"{t * 1e3:.1f}" for t in catch_up)
        + f" ms; lag max {max((l.seqs for l in lags), default=0)} seqs, "
        f"{max((l.seconds for l in lags), default=0.0) * 1e3:.1f} ms "
        f"(sampled {len(lags)} times); promote() "
        f"{failover_s:.2f} s to term {term}; the promoted engine equals the "
        f"acknowledged prefix (seq {acked}) bit for bit; the deposed "
        f"primary's append and ship raise FencedError; {len(cl.served)} "
        f"standby reads, 0 failed; the promoted loop took a write "
        f"(role {ms.role}, term {ms.term})")
    sl.close()
    pl.close()
    launches = {name: mod.launches for name, mod in kernel_modules().items()}
    log(f"serving: kernel launches (replays counted) {launches}")
    need_launches(launches, ("fastscan_stream_topk", "rerank_stream_topk"),
                  "serving")
    del prim, stb, pl, sl
    gc.collect()
    torch.cuda.empty_cache()

    # the kill-9 drills, one kill point each, in processes of their own
    for extra in ([], ["--replication"]):
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, os.path.join(root, "tools",
                                          "crash_test_torch.py"),
             "--kill-at", "3", "--steps", "6", "--dir",
             os.path.join(work, "crash" + "".join(extra))] + extra,
            capture_output=True, text=True, timeout=600, cwd=root)
        lines = (out.stdout + out.stderr).strip().splitlines()
        log(f"serving: crash drill {' '.join(extra) or '(recovery)'} "
            f"[{time.perf_counter() - t0:.1f} s]: " + " | ".join(lines[-2:]))
        if out.returncode != 0:
            raise AssertionError("serving: the crash drill failed:\n"
                                 + "\n".join(lines[-20:]))
    shutil.rmtree(work, ignore_errors=True)
    return launches


def ivf_engine(torch, args, nq: int):
    """The data (a SIFT1M-shaped base with ``nq`` queries and exact ground
    truth, made on the card from ``args.seed``) and the IVF engine of the
    stream path over it: (dataset, engine, index build seconds)."""
    from repro_torch.core.lists import grow_cap
    from repro_torch.data.vectors import make_sift_like
    from repro_torch.engine import EngineConfig, SearchEngine
    from repro_torch.kernels.fastscan_kernel import TILE_N
    t0 = time.perf_counter()
    ds = make_sift_like(n=args.n, nt=args.nt, nq=nq, d=128, seed=args.seed,
                        device="cuda")
    torch.cuda.synchronize()
    log(f"data: {args.n} x 128 base, {args.nt} train, {nq} queries, exact "
        f"ground truth on the card [{time.perf_counter() - t0:.1f} s]")
    t0 = time.perf_counter()
    engine = SearchEngine.build(ds.train, ds.base, m=M, nlist=args.nlist,
                                config=EngineConfig(nprobe=NPROBE,
                                                    rerank_mult=RERANK_MULT,
                                                    scan_impl="stream",
                                                    rerank_impl="stream"),
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
    return ds, engine, build_s


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--nt", type=int, default=100_000)
    ap.add_argument("--nlist", type=int, default=1024)
    args = ap.parse_args()

    t_main = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(root, "src"))
    import repro_torch  # noqa: F401  (fails outside the repo)
    from repro_torch.core.fastscan import build_index
    from repro_torch.kernels import _build

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
    for line in ptxas_summary(_build.build_log, PTXAS_SUMMARY):
        log(f"ptxas: {line}")

    # set-up: data and the index the slice phase serves (its cap shapes K1)
    nq = (BATCHES_PER_BUCKET + 1) * sum(BUCKETS) + 32
    ds, engine, build_s = ivf_engine(torch, args, nq)
    # the flat path's index over the same base (the paper's Fig. 2 setting)
    t0 = time.perf_counter()
    flat = build_index(ds.train, ds.base, m=M, seed=args.seed, device="cuda")
    torch.cuda.synchronize()
    log(f"flat index: {flat.n} rows, M={M}, K=16, "
        f"{flat.packed_codes.numel()} code bytes, built in "
        f"{time.perf_counter() - t0:.2f} s")

    # 3-4. kernels against their plain versions
    cap = engine.index.cap
    k1 = k1_phase(torch, args, cap, args.nlist)
    k2 = k2_phase(torch, args, engine.base, engine.base_norms)
    k3, k5, k6 = grouped_phases(torch, args, cap, args.nlist)
    k4 = k4_phase(torch, args, cap, args.nlist)
    k7a, k7b, k7c = flat_kernel_phases(torch, args, flat, ds.queries)
    # the one-hot scans' products against mma.sync's own rate
    rate = mma_yardstick(torch)
    for kern in (k6, k7b, k7c):
        log(f"{kern['name']}: {kern['mmas']} MMAs take "
            f"{kern['mmas'] / rate * 1e3:.6f} ms at the yardstick's rate; "
            f"{kern['ms']:.6f} ms this run")

    # 5. the stream serving path
    launches = slice_phase(torch, args, engine, ds, build_s)
    k1["launches"] = launches["fastscan_stream_topk"]
    k2["launches"] = launches["rerank_stream_topk"]
    # 5b. search_jit's graphs on the stream path, with a namespaced batch:
    # N_TENANTS tenants, each a random quarter of the lists
    perm = np.random.default_rng(args.seed + 9).permutation(args.nlist)
    members = np.zeros((N_TENANTS, args.nlist), bool)
    for t, part in enumerate(np.array_split(perm, N_TENANTS)):
        members[t, part] = True
    launches = graph_phase(torch, args, engine, ds, "stream", engine.config,
                           members)
    need_launches(launches, ("fastscan_stream_topk", "rerank_stream_topk"),
                  "stream graph")
    # 6. the anytime, autotuned serving path
    tuned_file = os.path.join(root, "build", "chip_smoke_autotune.json")
    os.makedirs(os.path.dirname(tuned_file), exist_ok=True)
    launches = anytime_phase(torch, args, engine, ds, tuned_file)
    for kern in (k3, k4, k5, k6):
        kern["launches"] = launches[kern["name"]]
    # 6b. search_jit's graphs on the anytime path, under pinned verdicts
    from repro_torch.kernels import ops
    pinned = os.path.join(root, "build", "chip_smoke_pinned_verdicts.json")
    g_max = AT_QMAX * AT_NPROBE
    sig = ("scan", "cuda", False, g_max, cap, M, args.nlist, 0.5)
    fresh = ops.autotune_cache()[sig]
    pin_verdicts(pinned, cap, args.nlist, args.n)
    ops.clear_autotune_cache()
    log(f"anytime graph: {ops.load_autotune_cache(pinned)} pinned verdicts "
        f"from {os.path.relpath(pinned, root)}")
    pin = ops.autotune_cache()[sig]
    log(f"anytime: scan verdict at G={g_max}: fresh {fresh.impl}@"
        f"{fresh.tile_n} (timings_us "
        + " ".join(f"{name}={us:.1f}" for name, us in fresh.timings_us)
        + f"), pinned {pin.impl}@{pin.tile_n}")
    launches = graph_phase(torch, args, engine, ds, "anytime",
                           anytime_config())
    need_launches(launches, ("fastscan_stream_topk_prune",
                             "fastscan_select_grouped", "rerank_stream_topk"),
                  "anytime graph")
    # 7. the flat path: fast-scan (K7a, K7b) beside naive PQ, and K7c
    launches = flat_phase(torch, args, ds, flat)
    for kern in (k7a, k7b, k7c):
        kern["launches"] = launches[kern["name"]]
    # 8. live mutation on the stream path's configuration, its own engine
    launches = mutation_phase(torch, args, engine, ds)
    need_launches(launches, ("fastscan_stream_topk", "rerank_stream_topk"),
                  "mutation")
    # 9. the stream index across SHARDS shards, with writes
    sharded_phase(torch, args, engine, ds)
    # 10. the coarse zoo: the paper's Table 1 pipeline (HNSW, tree, flat)
    del flat
    coarse_phase(torch, args)
    # 11. durable serving: the loop, the WAL, snapshots, failover, drills
    log(f"serving: phase starts {time.perf_counter() - t_main:.1f} s into "
        "the run")
    t0 = time.perf_counter()
    serving_phase(torch, args, engine, ds, root)
    log(f"serving: phase {time.perf_counter() - t0:.1f} s; the run so far "
        f"{time.perf_counter() - t_main:.1f} s")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = (k1, k2, k3, k4, k5, k6, k7a, k7b, k7c)
    if any(kern["launches"] < 1 for kern in kernels):
        raise AssertionError("a kernel was not launched on its path")
    # the next slice's order of work (no kernel has a library call yet):
    # launches on the path x (ms - bound_ms), the time above the bound
    gap = sorted(((kern["launches"] * (kern["ms"] - kern["bound_ms"]),
                   kern["name"]) for kern in kernels), reverse=True)
    for kern in kernels:
        if kern["name"] in EARLIER_MS:
            log(f"{kern['name']}: {kern['ms']:.6f} ms this run, "
                f"{EARLIER_MS[kern['name']]:.6f} ms before its redesign, "
                f"bound {kern['bound_ms']:.6f} ms "
                f"({kern['bound_by']})")
    log("launches x (ms - bound_ms), largest first: "
        + ", ".join(f"{name} {v:.4f}" for v, name in gap))
    log(json.dumps({"kernels": [{key: kern[key] for key in keys}
                                for kern in kernels]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

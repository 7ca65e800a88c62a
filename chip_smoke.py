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

  8. LM serving (``repro_torch.launch.serve``): qwen3-1.7b's full config
     in bf16 (28 layers, d_model 2048, GQA 16/8 x 128, vocab 151,936),
     weights from a seeded ``torch.Generator``, ``serve_batch`` on 8
     prompts of 2,048 tokens with 64 new tokens (max_seq 4,096), each
     decode step a replay of a captured CUDA graph
     (``models/decode_graph.py``), through the exact KV cache, held
     against the teacher-forced ``forward`` (max |logit difference| under
     5e-2 of max |logit|, the reference's own tolerance), then through the
     4-bit PQ KV cache (calibrated codebooks, M = 64) whose decode
     attention is K8, launched at least 28 x 63 times. Then, a cache
     each, the graph against the eager step bit for bit over the 63 steps
     (logits, tokens, every cache tensor), both timed (host clock) and
     profiled (device time, ops, idle share). It prints prefill seconds,
     decode ms a step and tokens/s, the graph's capture seconds,
     calibration seconds, cache bytes, the exact-vs-PQ token agreement (a
     figure: the weights are random), peak memory, and K8 held against its
     plain version at the path's shapes and edges (position 0, Smax - 1,
     g = 1, g = 12 as starcoder2-15b has it, both LUT kinds, f32), its
     error against its split-order twin printed, and timed, both of its
     passes together, beside its bound and its time before the split
     redesign (20 back-to-back calls replayed as one CUDA graph: the
     profiler drops K8's records).

  9. the recurrent families at full width and depth, B = 8, 2,048-token
     prompts, 32 new tokens: zamba2-2.7b (54 Mamba2 layers, the shared
     attention block every 6) through ``serve_batch`` on the exact
     shared-attention cache, then its published 4-bit PQ cache (codebooks
     calibrated here a group at a time: the reference's serve_batch has
     none for a hybrid) through ``prefill(pq_cache=...)`` and graph
     replays, K8 launched at least 9 x 31 times and held against its plain
     version at head_dim 80 / M 40 / g 1; and rwkv6-3b (32 layers,
     ``rwkv_chunk`` 128 -> 32, logged as a reduction) through
     ``serve_batch``, and one prefill at the published chunk 128, whose
     logits it reports as finite or not (the reference's WKV6 overflows
     there). Graph against eager bit for bit on each cache. In bf16 the
     recurrent decode's departure from the forward is printed as a figure;
     the same seeded weights in f32 are held against the forward at 5e-2
     (rwkv6 at full depth, zamba2 at 18 layers: its shared attention
     multiplies a perturbation ~10x a block on these weights, which a
     probe prints group by group). The SSD and WKV6 scans' device times.

  10. the frontend stubs' archs whole in bf16: internvl2-1b (24 layers,
     GQA 14/2 x 64, qkv_bias) and musicgen-medium (48 layers, MHA 24 x
     64, gelu): seeded (B, frontend_len, D) embeddings through ``forward``
     and the exact ``prefill`` (equal embeddings equal logits, causal
     reach, prefill against forward), then ``serve_batch`` on 8 x 2,048
     tokens with 32 new: the exact cache (its decode against the forward
     a figure on the reference's init, whose unnormalized attention is
     near one-hot, and held at 5e-2 with the attention conditioned), the
     PQ cache through K8 (launched at least L x 31 times), graph against
     eager on both, K8 against its plain version at each arch's shapes.

  11. the MoE archs at full width, depth cut to ``ONE_CARD_LAYERS`` (dbrx-132b
     8 of 40 layers, llama4-scout-17b-a16e 12 of 48, logged as
     reductions), 16 new tokens: the prefill's drop share under the
     published capacity, the exact cache at the published capacity (a
     figure) and at the check-only capacity E / k (no token drops; held
     against the forward with the attention conditioned), the PQ cache
     through K8, graph against eager,
     the decode step beside its byte bound (every expert's weights a
     step), K8 at the path's shapes; peak memory a model.

  12. LM training (``repro_torch.train``): qwen3-1.7b's full config in
     bf16, whole (28 layers, the published remat group:7 and loss_chunk
     512), seeded random weights, a global batch of 8 x 2,048 tokens from
     ``data.tokens.batch_at_step`` (seed 0) in 2 microbatches, AdamW
     (total 8 steps, warm-up 2): step 1's gradients profiled, the 4-bit
     PQ gradient codec (``grad_compress.ef_step``) once over them (ratio,
     ms, each leaf's relative error), then 8 steps through
     ``make_train_step`` (each synchronised: ms, tokens/s, the model-FLOP
     share of the bf16 peak, peak memory; every loss and grad_norm finite,
     the loss falling), an ``AsyncCheckpointer`` save after step 4
     written while steps 5-8 run (bytes, seconds), and a restore of step
     4 into a fresh state whose steps 5-8 equal the uninterrupted run's
     bit for bit (the losses, and every parameter, moment and the step),
     under deterministic algorithms (``CUBLAS_WORKSPACE_CONFIG`` is set
     before the first cuBLAS call); then one step each of zamba2-2.7b and
     rwkv6-3b (``rwkv_chunk`` 32, the serving phase's reduction) at full
     width and depth, B 2 x 2,048: a finite loss and gradient norm, step
     ms and peak memory. It adds no kernel: none is on the training path.

  13. the LM under a one-rank device mesh (``launch/mesh.py``,
     ``launch/sharding.py``): a one-rank NCCL process group on a free
     local port and ``make_host_mesh()``'s (1, 1) ``DeviceMesh`` on the
     card; under ``use_mesh``, qwen3-1.7b's exact and PQ decode (eager
     and as decode-graph replays, 8 steps at the LM phase's shapes) and
     one training step at the training phase's, each equal to the
     meshless run bit for bit, 28 K8 launches a PQ step; the eager step's
     ms with and without the mesh; qwen3-1.7b's prefill and 8 eager
     decode steps through ``launch.dryrun.mesh_cell`` with parameters,
     caches and batch as DTensors, exact and PQ, bit for bit the meshless
     steps, 28 K8 launches a PQ step; K8's sharded mode (its split pass
     over each of 2 and 4 shards of qwen3's PQ cache at their offsets,
     the combine pass over the partials) bit for bit the one-rank K8,
     each pass timed; the per-device bytes of the card's cells on the
     reference's pod and multipod meshes. The group is destroyed before
     the examples. Then dbrx-132b's expert-parallel bodies over 2 and 4
     shards of one full-width layer, in turn. The machine has one card:
     a mesh of several ranks runs as gloo ranks on the CPU (the tests).
     K8's launches on the mesh cells' PQ path and in the sharded runs
     are printed on ``mesh:`` lines of their own; the kernels line counts
     the LM phase's PQ path alone.

  14. ``examples/quickstart_torch.py`` and ``examples/ann_search_torch.py
     --shards 4`` once each, in their own processes.

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
for bit (K2 within tolerance; K8 in the LM phase, its output within a
stated tolerance, its scores bit for bit) against its plain version at the
shapes its path gives it, and timed beside its bound: the larger of the bytes the
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
import shutil
import subprocess
import sys
import time

import numpy as np

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
                 "blockmin_kernel", "pq_decode_kernel")


class _Lazy:
    """A module of the port imported at first use, once ``main`` has put
    ``src/`` on the path."""

    def __init__(self, name: str):
        self._name = name

    def __getattr__(self, attr):
        import importlib
        return getattr(importlib.import_module(self._name), attr)


# the card's peaks and each kernel's bytes and ops: one yardstick for this
# run, the dry-run and the tests; and the dry-run's byte counting
rl = _Lazy("repro_torch.launch.roofline")
ca = _Lazy("repro_torch.launch.cost_analysis")


# what the LM and training phases measured a path, by its name there, for
# the dry-run's count of the same path (dryrun_phase)
MEASURED: dict = {}


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


def graph_ms(torch, fn, calls: int, reps: int = 5) -> float:
    """Device ms a call of ``fn``: ``calls`` back-to-back calls captured as
    one CUDA graph, its replays timed by CUDA events (no host gaps between
    the calls, and no profiler to drop their records)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    ms = event_ms(torch, graph.replay, reps, warmup=1) / calls
    del graph
    return ms


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
    # that are occupied and pass the filter, its bitmap bytes and size,
    # every LUT and probe id, the outputs written once
    counts = rl.stream_counts(probes_np, sizes_np, cap, bits_np)
    nbytes, ops_count, bound, by = kernel_bound(
        "K1", "fastscan_stream_topk", g=g, m=M, kc=kc, n_tiles=cap // tile,
        live_rows=counts["live_rows"], lists=counts["lists"],
        filter_bytes=w, group_rows=counts["group_rows"])
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
        nbytes, flops, bound, by = kernel_bound(
            f"K2 Q={qq} tile={tile}", "rerank_stream_topk", q=qq, d=d, rp=rp,
            k=kk, valid=valid)
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
    from repro_torch.kernels import pq_decode_kernel as pqk
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
            "fastscan_blockmin": bk,
            "pq_decode_attention": pqk}


def need_launches(launches: dict, names, what: str) -> None:
    """Fail unless each named kernel launched on the path just run."""
    missing = [name for name in names if launches[name] < 1]
    if missing:
        raise AssertionError(f"{what}: {missing} not launched: {launches}")


def zero_counts() -> None:
    for mod in kernel_modules().values():
        mod.launches = 0


def kernel_bound(what: str, name: str, **shape):
    """The least time (ms) the card could take for one call of the kernel
    ``name`` at ``shape``, and which term binds
    (``roofline.kernel_cost``: each input read once and each output
    written once at the memory rate, against the function's own
    operations at their type's peak, never a formulation's). Prints the
    shape on a ``cost:`` line. Returns (bytes, ops, bound ms, bound by)."""
    nbytes, ops, peak = rl.kernel_cost(name, **shape)
    bound, by = rl.bound_ms(nbytes, ops, peak)
    log(f"cost: {what} {json.dumps({'name': name, **shape})} -> {nbytes} B, "
        f"{ops} ops at {peak:.6e}/s, bound {bound:.6f} ms ({by})")
    return nbytes, ops, bound, by


def assert_same(got, want, what: str) -> None:
    for i, (a, b) in enumerate(zip(got, want)):
        if not bool((a == b).all()) or a.shape != b.shape:
            raise AssertionError(f"{what}: kernel != plain in output {i} "
                                 f"({int((a != b).sum())} entries)")


def time_kernel(torch, kernel, plain, dev_name: str, shape: dict,
                what: str, **entry) -> dict:
    """Profiler and event time of ``kernel``, the plain version's time and
    the bound at ``shape`` (``kernel_bound``); the kernel's entry of the
    kernels line (launches are filled in by the path that drives it)."""
    ms_events = event_ms(torch, kernel, 20)
    ms_dev = device_ms(torch, kernel, dev_name, 10)
    plain_ms = event_ms(torch, plain, 3, warmup=1)
    nbytes, ops_count, bound, by = kernel_bound(what, entry["name"], **shape)
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
        f"({100 * rate * 16 * 8 * 32 * 2 / rl.PEAK_INT8_OPS:.1f}% of "
        f"{rl.PEAK_INT8_OPS / 1e12:.0f})")
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
    counts = rl.stream_counts(probes_np, np.full(nlist, cap), cap)
    log(f"K3 fastscan_stream_grouped: G={g} nlist={nlist} cap={cap} M={M} "
        f"tile={tile} invalid_probes={int((~valid).sum())}: kernel == plain "
        "bit for bit")
    out.append(time_kernel(
        torch, k3, k3_plain, "stream_grouped_kernel",
        dict(g=g, m=M, cap=cap, lists=counts["lists"],
             groups=counts["groups"]), "K3",
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
            torch, kernel, plain, dev_name, dict(g=g, n=n_p, m=M), what,
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

    small = rl.stream_counts(probes_np[:gs], np.full(nlist, cap), cap)
    for what, fn, plain_out, dev_name, name, shape, earlier in (
            ("K3", k3_small, sgk.fastscan_stream_grouped_plain(
                t_s, store, p_s, tile_n=tile), "stream_grouped_kernel",
             "fastscan_stream_grouped",
             dict(g=gs, m=M, cap=cap, lists=small["lists"],
                  groups=small["groups"]), EARLIER_K3_MS.get(gs)),
            ("K5", k5_small, sk.fastscan_grouped_plain(t_s, c_s, tile_n=gtile),
             "select_grouped_kernel", "fastscan_select_grouped",
             dict(g=gs, n=n_p, m=M), EARLIER_K5_MS.get(gs))):
        assert_same((fn(),), (plain_out,), f"{what} G={gs}")
        ms_dev = device_ms(torch, fn, dev_name, 20)
        _, _, bound, by = kernel_bound(f"{what} G={gs}", name, **shape)
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
        counts = rl.pruned_counts(probes_np, sizes_np, host["bits"], skipped,
                                  cap, tile)
        out = time_kernel(
            torch, kernel, plain, "stream_topk_prune_kernel",
            dict(g=g, m=M, kc=kc, tile=tile, n_tiles=n_tiles, **counts),
            "K4", name="fastscan_stream_topk_prune",
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
            torch, kernel, plain, dev_name, dict(q=qq, n=n, m=M), what,
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
        for fn, dev_name, what, name in (
                (mfk.fastscan_onehot_mxu, "onehot_mma_flat_kernel", "K7b",
                 "fastscan_onehot_mma_flat"),
                (sfk.fastscan_select_tree, "select_flat_kernel", "K7a",
                 "fastscan_select_flat")):
            _, _, bound, by = kernel_bound(f"{what} Q={qs}", name, q=qs, n=n,
                                           m=M)
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
        _, _, bound, by = kernel_bound(f"K7c Q={qs}", "fastscan_blockmin",
                                       q=qs, n=n_ff, m=M, block=block)
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
        dict(q=qq, n=n_ff, m=M, block=block), "K7c", name="fastscan_blockmin",
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


LM_ARCH = "qwen3-1.7b"          # the LM phase's model, full CONFIG
LM_BATCH, LM_PROMPT, LM_GEN, LM_MAX_SEQ = 8, 2048, 64, 4096
REC_GEN = 32                  # new tokens a request, recurrent families
# the depth at which zamba2's f32 decode is held against its forward: three
# shared-attention blocks (each multiplies a perturbation ~10x on these
# weights, so f32 rounding survives three, not nine)
ZAMBA2_HELD_LAYERS = 18
# the frontend stubs' archs, served whole, and their new tokens a request
FRONTEND_ARCHS = ("internvl2-1b", "musicgen-medium")
FRONTEND_GEN = 32
# new tokens a request of the MoE archs, served at full width with their
# depth cut to repro_torch.configs.ONE_CARD_LAYERS
MOE_GEN = 16
# the exact decode's logits against the teacher-forced forward's, as the
# reference's own test holds them (tests/test_model_consistency.py): the
# largest |difference| below 5e-2 of the largest |logit|
LM_FORWARD_RTOL = 5e-2
# K8 against its plain version, of each (row, head)'s largest |value|: in
# bf16 four units in the last place (2**-6): each side's rounding of the
# output (half a unit each), the plain version's rounding of each
# 2,048-position chunk's value sum to bf16 (K8 sums each 256-position
# split in f32 and combines the splits in f32; half a unit a chunk), and
# p rounded to bf16 at another max (each split's own, then scaled by
# e^(m_j - m*) in f32: the same half unit a term as a rounding at a
# running max); in f32 the two orders (the splits' exponentials at their
# own maxima, scaled and summed in another order), 1e-5. The q8 scores
# are held bit for bit.
K8_RTOL = {"bfloat16": 2.0 ** -6, "float32": 1e-5}
# K8's graph-replay ms a call at each path's shapes before its split
# redesign (the last chip_smoke.py run before it, NVIDIA H100 80GB HBM3,
# 700 W), printed beside this run's; not part of the kernels line
K8_EARLIER_MS = {"lm": 0.128003, "zamba2": 0.174516, "internvl2": 0.143279,
                 "musicgen": 0.105408, "dbrx": 0.252949, "llama4": 0.217798}


def k8_inputs(torch, seed: int, *, b: int, smax: int, kv: int, g: int,
              m: int, dsub: int, positions, q8: bool, dtype):
    """K8's arguments as the decode step's glue makes them (LUTs from a
    random q through ``kvcache._build_ip_lut`` and ``_quantize``), over
    random codes and codebooks on the card."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    hd = m * dsub
    q = torch.randn((b, kv * g, hd), generator=gen, device="cuda").to(dtype)
    kc, vc = (torch.randint(0, 256, (b, smax, kv, m // 2), generator=gen,
                            device="cuda", dtype=torch.uint8)
              for _ in range(2))
    kcb, vcb = (torch.randn((kv, m, 16, dsub), generator=gen, device="cuda"
                            ).to(dtype) for _ in range(2))
    return k8_glue(torch, q, kc, vc, kcb, vcb, positions, q8)


def k8_glue(torch, q, kc, vc, kcb, vcb, positions, q8: bool):
    from repro_torch.models import kvcache as kvc
    b, h, hd = q.shape
    kv = kc.shape[2]
    lut = kvc._build_ip_lut(q.reshape(b, kv, h // kv, hd), kcb) / hd ** 0.5
    table, scale, bias = (kvc._quantize(lut) if q8
                          else (lut.contiguous(), None, None))
    pos = torch.as_tensor(np.broadcast_to(np.asarray(positions, np.int32),
                                          (b,)).copy(), device="cuda")
    return table, scale, bias, kc, vc, vcb, pos


def k8_check(torch, args, out_dtype, chunk: int, what: str) -> float:
    """K8 against its plain version on the same inputs (not counted as a
    path launch): the output within K8_RTOL, each live position's score
    bit for bit (q8) or within 1e-5, dead ones unwritten. Returns the
    largest error relative to its row's largest |value|."""
    from repro_torch.kernels import pq_decode_kernel as pqk
    table, scale, bias, kc = args[:4]
    b, kv, g = table.shape[:3]
    smax = kc.shape[1]
    scores = torch.full((b, kv, g, smax), float("-inf"), device="cuda")
    n0 = pqk.launches
    got = pqk.pq_decode(*args, chunk=chunk, out_dtype=out_dtype,
                        scores=scores)
    pqk.launches = n0
    want = pqk.pq_decode_plain(*args, chunk=chunk, out_dtype=out_dtype)
    torch.cuda.synchronize()
    scale_row = want.float().abs().amax(-1, keepdim=True).clamp_min(1e-30)

    def rel(x, y):
        return float(((x.float() - y.float()).abs() / scale_row).max())

    err = rel(got, want)
    tol = K8_RTOL[str(out_dtype).split(".")[-1]]
    # the kernel's own order in plain PyTorch (splits, then the combine):
    # a diagnostic
    twin = pqk.pq_decode_plain(*args, chunk=chunk, out_dtype=out_dtype,
                               split=pqk.SPLIT)
    log(f"lm: K8 {what}: against the split-order twin {rel(got, twin):.3e}")
    if out_dtype == torch.bfloat16:
        # both against the function in f32 throughout (f32 codebooks, no
        # rounding of p, of the chunk sums or of the output): a diagnostic
        f32 = pqk.pq_decode_plain(*args[:5], args[5].float(), args[6],
                                  chunk=chunk, out_dtype=torch.float32)
        log(f"lm: K8 {what}: against the f32 twin: K8 {rel(got, f32):.3e}, "
            f"plain {rel(want, f32):.3e}")
    live = (torch.arange(smax, device="cuda")[None]
            <= args[6].long()[:, None])[:, None, None, :].expand_as(scores)
    plain_s = pqk.adc_scores(table, scale, bias, kc)
    if table.dtype == torch.uint8:
        s_ok = bool(torch.equal(scores[live], plain_s[live]))
    else:
        s_ok = bool(torch.allclose(scores[live], plain_s[live], rtol=1e-5,
                                   atol=1e-5))
    s_ok = s_ok and bool(torch.isinf(scores[~live]).all())
    log(f"lm: K8 {what}: max error {err:.3e} of the row's largest |value| "
        f"(tolerance {tol:.3e}); scores {'held' if s_ok else 'DIFFER'}")
    if not (err <= tol and s_ok):
        raise AssertionError(f"K8 {what}: kernel != plain ({err}, scores "
                             f"{s_ok})")
    return err


def fresh_pq(torch, pq_cache):
    """``pq_cache`` with code tensors of its own: the attention family's
    prefill fills a ``PQKVCache``'s codes in place, and the hybrid's a
    whole cache dict's codes and states (a dict of its codebooks alone is
    only read)."""
    from repro_torch.models import kvcache as kvc
    if isinstance(pq_cache, kvc.PQKVCache):
        return pq_cache._replace(k_codes=torch.zeros_like(pq_cache.k_codes),
                                 v_codes=torch.zeros_like(pq_cache.v_codes))
    if isinstance(pq_cache, dict) and "attn_k_codes" in pq_cache:
        return {k: t if k.endswith("_cb") else torch.zeros_like(t)
                for k, t in pq_cache.items()}
    return pq_cache


def graph_vs_eager(torch, params, cfg, prompts, pq_cache, steps: int,
                   what: str) -> dict:
    """Two caches prefilled alike; ``steps`` decode steps, eagerly on one and
    as replays of a ``DecodeGraph`` on the other, fed the same tokens (the
    eager step's argmax): the logits bit for bit at every step, then every
    cache tensor. Host ms a step (synchronized; median over the steps after
    the graph's first, which captures), one profiled step of each (device
    ms, device ops, idle share) and the replay's back-to-back event time.
    Leaves K8's count as it found it."""
    from repro_torch.kernels import pq_decode_kernel as pqk
    from repro_torch.models import model as model_lib
    from repro_torch.models.decode_graph import DecodeGraph, cache_tensors
    n0 = pqk.launches
    b, s = prompts.shape
    (lg, eager), (_, graphed) = (
        model_lib.prefill(params, prompts, cfg, max_seq=LM_MAX_SEQ,
                          pq_cache=fresh_pq(torch, pq_cache))
        for _ in range(2))
    graph = DecodeGraph(params, graphed, cfg, b)
    tok = torch.argmax(lg[:, :cfg.vocab], -1)
    t_e, t_g = [], []
    for i in range(steps):
        pos = torch.full((b,), s + i, dtype=torch.int32, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want, _ = model_lib.decode_step(params, eager, tok, pos, cfg)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        got = graph.step(tok, pos)
        torch.cuda.synchronize()
        t_e.append((t1 - t0) * 1e3)
        t_g.append((time.perf_counter() - t1) * 1e3)
        if not torch.equal(got, want):
            raise AssertionError(
                f"{what}: graph != eager at step {i}: max |difference| "
                f"{float((got.float() - want.float()).abs().max())}")
        tok = torch.argmax(want[:, :cfg.vocab], -1)
    for a, c in zip(cache_tensors(graphed), cache_tensors(eager)):
        if not torch.equal(a, c):
            raise AssertionError(f"{what}: graph and eager caches differ")
    out = dict(eager_ms=float(np.median(t_e[1:])),
               graph_ms=float(np.median(t_g[1:])),
               capture_s=graph.capture_seconds())
    pos = torch.full((b,), s + steps, dtype=torch.int32, device="cuda")
    # the eager step's own memory: its peak above what was allocated before
    # it, beside the bytes of its parameters and cache (for dryrun_phase)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    model_lib.decode_step(params, eager, tok, pos, cfg)
    torch.cuda.synchronize()
    out["step_peak"] = torch.cuda.max_memory_allocated() - base
    out["static_real"] = ca.tree_bytes(params, eager)
    for kind, fn in (("eager", lambda: model_lib.decode_step(
            params, eager, tok, pos, cfg)), ("graph",
                                             lambda: graph.step(tok, pos))):
        _, busy, ops, rows = breakdown(torch, fn)
        k8 = sum(ms for name, ms in rows if "pq_decode_kernel" in name)
        out[kind] = dict(busy=busy, ops=ops, k8=k8, rows=rows)
    out["replay_ms"] = event_ms(torch, lambda: graph.step(tok, pos), 10)
    MEASURED[what] = dict(out, cfg=cfg, batch=b, smax=LM_MAX_SEQ,
                          live=s + steps + 1)
    log(f"{what}: graph == eager bit for bit over {steps} steps (logits, "
        f"tokens, every cache tensor); capture {out['capture_s']:.3f} s")
    for kind in ("eager", "graph"):
        st, ms = out[kind], out[kind + "_ms"]
        log(f"{what}: {kind} step {ms:.3f} ms (host clock, synchronized, "
            f"median of {steps - 1}); profiled device time {st['busy']:.4f}"
            f" ms in {st['ops']} ops, idle {1 - st['busy'] / ms:.4f} of the "
            f"step" + (f"; K8 {st['k8']:.4f} ms = {st['k8'] / st['busy']:.4f}"
                       f" of it" if st["k8"] else ""))
        for name, dms in st["rows"][:5]:
            log(f"    {dms:.4f} ms  {name[:90]}")
    log(f"{what}: a replay back to back {out['replay_ms']:.4f} ms (CUDA "
        "events)")
    del graph, graphed, eager
    pqk.launches = n0
    return out


def serve_exact(torch, cfg, params, prompts, gen: int, what: str,
                hold: bool = True):
    """``serve_batch`` through the exact cache (graph replays), its decode
    against the teacher-forced ``forward``: held within LM_FORWARD_RTOL, or
    with ``hold`` False printed as a figure. Returns (tokens, stats, peak
    memory)."""
    from repro_torch.launch import serve
    from repro_torch.models import model as model_lib
    torch.cuda.reset_peak_memory_stats()
    st = {}
    tok, logits = serve.serve_batch(cfg, params, prompts, gen,
                                    max_seq=LM_MAX_SEQ, return_logits=True,
                                    stats=st)
    peak = torch.cuda.max_memory_allocated()
    b, s = prompts.shape
    t0 = time.perf_counter()
    full, _ = model_lib.forward(
        params, torch.cat([prompts, tok[:, :-1].to(torch.int32)], 1), cfg)
    ref = full[:, s - 1:].float()
    del full
    torch.cuda.synchronize()
    fwd_s = time.perf_counter() - t0
    diff = float((logits.float() - ref).abs().max())
    top = float(ref.abs().max())
    same_top = float((logits[..., :cfg.vocab].argmax(-1)
                      == ref[..., :cfg.vocab].argmax(-1)).float().mean())
    log(f"{what}: exact decode vs teacher-forced forward ({b} x "
        f"{s + gen - 1} tokens, {fwd_s:.2f} s): max |logit "
        f"difference| {diff:.4f} of max |logit| {top:.4f} = "
        f"{diff / top:.3e} ("
        + (f"tolerance {LM_FORWARD_RTOL}" if hold else "a figure, not held")
        + f"); the same top token at {same_top:.4f} of the {gen} positions "
        f"x {b}")
    if hold and not diff / top < LM_FORWARD_RTOL:
        raise AssertionError(f"{what}: exact decode != forward ({diff / top})")
    check_tokens(tok, cfg, b, gen, what)
    return tok, st, peak


def check_tokens(tok, cfg, b: int, gen: int, what: str) -> None:
    if tok.shape != (b, gen) or int(tok.min()) < 0 or \
            int(tok.max()) >= cfg.vocab:
        raise AssertionError(f"{what}: tokens {tuple(tok.shape)} out of "
                             "shape or vocab")


def log_serve(what: str, st: dict, peak: int, b: int, prompt: int) -> None:
    new = b * st["decode_steps"]
    log(f"{what}: calibrate {st.get('calibrate_s', 0.0):.3f} s, prefill "
        f"{st['prefill_s']:.3f} s ({b} x {prompt} tokens), decode "
        f"{st['decode_s'] / st['decode_steps'] * 1e3:.3f} ms a step of {b} "
        f"({new / st['decode_s']:.1f} tokens/s over {st['decode_steps']} "
        f"steps, graph capture {st.get('capture_s', 0.0):.3f} s of it); "
        f"max_memory_allocated {peak} B")


def k8_time(torch, path, cfg, live: int, launches: int, what: str):
    """K8's times on ``path`` (its arguments at a path's shapes, back to
    back on one layer's codes; a call is both of its passes): as graph
    replays (the figure returned),
    by the profiler and by CUDA events around eager calls (host gaps
    included); the plain version's; and its bound there: (ms, plain ms,
    bound ms, bound by). Leaves K8's count as it was."""
    from repro_torch.kernels import pq_decode_kernel as pqk
    table = path[0]
    b, kv, g, m, _ = table.shape
    hd = cfg.resolved_head_dim

    def kernel():
        pqk.pq_decode(*path, chunk=2048, out_dtype=torch.bfloat16)

    def plain():
        pqk.pq_decode_plain(*path, chunk=2048, out_dtype=torch.bfloat16)

    n0 = pqk.launches
    ms_ev = event_ms(torch, kernel, 20)
    ms_dev = device_ms(torch, kernel, "pq_decode_kernel", 20)
    ms = graph_ms(torch, kernel, 20)
    plain_ms = event_ms(torch, plain, 3, warmup=1)
    pqk.launches = n0
    nbytes, ops, bound, by = kernel_bound(
        f"{what}: K8", "pq_decode_attention", b=b, kv=kv, g=g, m=m,
        head_dim=hd, live=live, q8=table.dtype == torch.uint8,
        cb_itemsize=path[5].element_size(), out_itemsize=2)
    log(f"{what}: K8 time at the path's shapes, back to back on one layer's "
        f"codes (warm in L2): graph replays {ms:.6f} ms a call (before the "
        f"split redesign {K8_EARLIER_MS[what]:.6f} ms: "
        f"{ms / K8_EARLIER_MS[what]:.3f}x), profiler (both passes) "
        f"{ms_dev} ms, events {ms_ev:.5f} ms, plain {plain_ms:.5f} ms, bound "
        f"{bound:.6f} ms ({by}: {nbytes} B; {ops} int8 and f32 ops), "
        f"{launches} launches on the PQ run")
    return ms, plain_ms, bound, by


def lm_phase(torch, args) -> dict:
    """LM serving on the card: qwen3-1.7b's full CONFIG in bf16 (weights
    from a seeded ``torch.Generator``) through ``serve_batch`` on
    LM_BATCH prompts of LM_PROMPT tokens (numpy, ``--seed``), LM_GEN new
    tokens, max_seq LM_MAX_SEQ, each step a replay of the decode graph:
    the exact cache, held against the teacher-forced ``forward``, then the
    4-bit PQ cache (calibrated codebooks, M = head_dim / 2) through K8, its
    launches counted from 0. Then the graph against the eager step, bit for
    bit over the generated steps, a cache each, both timed and profiled;
    and K8 held against its plain version at the path's shapes and edges
    and timed. Returns K8's entry of the kernels line."""
    from repro_torch import configs
    from repro_torch.kernels import pq_decode_kernel as pqk
    from repro_torch.launch import serve
    from repro_torch.models import model as model_lib
    gc.collect()
    torch.cuda.empty_cache()
    dev = torch.device("cuda")
    cfg = configs.get_config(LM_ARCH)
    exact_cfg, pq_cfg = cfg.replace(kv_pq=False), cfg.replace(kv_pq=True)
    L, kv, hd = cfg.n_layers, cfg.n_kv_heads, cfg.resolved_head_dim
    m, g = cfg.resolved_kv_pq_m, cfg.n_heads // cfg.n_kv_heads
    t0 = time.perf_counter()
    params = model_lib.init_lm(
        cfg, generator=torch.Generator(device="cuda").manual_seed(args.seed),
        device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    log(f"lm: {cfg.name} full CONFIG ({L} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads / {kv} KV heads x {hd}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab} padded to {cfg.padded_vocab}, qk_norm, {cfg.mlp_type})"
        f": {n_params} parameters in {cfg.dtype} "
        f"({n_params * 2} B), random from seed {args.seed}, "
        f"{time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(args.seed + 24)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab, (LM_BATCH, LM_PROMPT),
                                           dtype=np.int32), device=dev)

    # the exact cache, and its decode against the teacher-forced forward
    tok_e, st_e, peak_e = serve_exact(torch, exact_cfg, params, prompts,
                                      LM_GEN, "lm")

    # the PQ cache through K8, its launches counted from 0
    launches, tok_p, _, _ = serve_pq(torch, args, pq_cfg, params, prompts,
                                     LM_GEN, "lm", L)
    agree = float((tok_e == tok_p).float().mean())
    exact_b = 2 * L * LM_BATCH * LM_MAX_SEQ * kv * hd * 2
    pq_codes_b = 2 * L * LM_BATCH * LM_MAX_SEQ * kv * (m // 2)
    pq_cb_b = 2 * L * kv * m * 16 * (hd // m) * 2
    log_serve("lm: exact", st_e, peak_e, LM_BATCH, LM_PROMPT)
    log(f"lm: cache bytes at max_seq {LM_MAX_SEQ}: exact {exact_b}, pq codes "
        f"{pq_codes_b} + codebooks {pq_cb_b} = {pq_codes_b + pq_cb_b} "
        f"({exact_b / (pq_codes_b + pq_cb_b):.2f}x smaller; M={m})")
    log(f"lm: exact-vs-pq token agreement {agree:.4f} (random weights: a "
        "figure, not a check)")

    # the decode graph against the eager step, a cache each
    pqc = serve.calibrate_pq_cache(torch.Generator().manual_seed(args.seed),
                                   params, pq_cfg, LM_BATCH, LM_MAX_SEQ)
    for what, c, pq in (("exact", exact_cfg, None), ("pq", pq_cfg, pqc)):
        graph_vs_eager(torch, params, c, prompts, pq, LM_GEN - 1,
                       f"lm: {what}")
    _, pq_cache = model_lib.prefill(params, prompts, pq_cfg,
                                    max_seq=LM_MAX_SEQ, pq_cache=pqc)
    pqk.launches = launches   # the path's count; checks below do not count

    # K8 against its plain version: the path's shapes (layer 0 of the PQ
    # cache, the last decode's position), then edges
    live = LM_PROMPT + LM_GEN - 1
    q = torch.randn((LM_BATCH, cfg.n_heads, hd), generator=torch.Generator(
        device="cuda").manual_seed(args.seed + 25), device=dev).to(
            torch.bfloat16)
    path = k8_glue(torch, q, pq_cache.k_codes[0], pq_cache.v_codes[0],
                   pq_cache.k_cb[0], pq_cache.v_cb[0], [live - 1], True)
    err = k8_check(torch, path, torch.bfloat16, 2048,
                   f"path shapes (B={LM_BATCH}, Smax={LM_MAX_SEQ}, KV={kv}, "
                   f"g={g}, M={m}, {live} live), q8")
    k8_check(torch, k8_glue(torch, q, pq_cache.k_codes[0],
                            pq_cache.v_codes[0], pq_cache.k_cb[0],
                            pq_cache.v_cb[0], [live - 1], False),
             torch.bfloat16, 2048, "path shapes, f32 LUT")
    edges = ((dict(positions=[0], q8=True, dtype=torch.bfloat16, g=g),
              "position 0"),
             (dict(positions=[LM_MAX_SEQ - 1], q8=True, dtype=torch.bfloat16,
                   g=g), "position Smax - 1"),
             (dict(positions=list(range(0, LM_MAX_SEQ, 512)), q8=False,
                   dtype=torch.bfloat16, g=1), "g = 1, f32 LUT, mixed"),
             (dict(positions=[live - 1], q8=True, dtype=torch.float32, g=g),
              "f32, q8"),
             (dict(positions=[-1, 5, LM_MAX_SEQ + 9, 2047, 2048, 3000, 77,
                              live - 1], q8=False, dtype=torch.float32, g=1),
              "f32, f32 LUT, g = 1, none live / past Smax"))
    for i, (kw, what) in enumerate(edges):
        gg = kw.pop("g")
        k8_check(torch, k8_inputs(torch, args.seed + 30 + i, b=LM_BATCH,
                                  smax=LM_MAX_SEQ, kv=cfg.n_heads // gg, g=gg,
                                  m=m, dsub=hd // m, **kw),
                 kw["dtype"], 2048, what)
    # starcoder2-15b's g = 12 (48 heads over 4 KV heads, head_dim 128), the
    # most query heads a KV head of the repo's configs
    for i, dtype in enumerate((torch.bfloat16, torch.float32)):
        k8_check(torch, k8_inputs(torch, args.seed + 40 + i, b=LM_BATCH,
                                  smax=LM_MAX_SEQ, kv=4, g=12, m=64, dsub=2,
                                  positions=[live - 1 - 97 * r
                                             for r in range(LM_BATCH)],
                                  q8=i == 0, dtype=dtype),
                 dtype, 2048, f"g = 12 (starcoder2-15b: KV 4, M 64), "
                 f"{'q8' if i == 0 else 'f32 LUT'}, {dtype}")
    pqk.launches = launches
    ms, plain_ms, bound, by = k8_time(torch, path, cfg, live, launches, "lm")
    del pq_cache, pqc, params
    gc.collect()
    torch.cuda.empty_cache()
    return dict(name="pq_decode_attention", route="cuda",
                source="src/repro_torch/kernels/csrc/pq_decode_attention.cu",
                replaces="src/repro/models/kvcache.py:156",
                launches=launches, max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                library_ms=None)


def full_model(torch, args, arch: str, **cut):
    """An arch's full CONFIG (``cut`` overrides, logged as reductions) in
    bf16 on seeded random weights, and its prompts."""
    from repro_torch import configs
    from repro_torch.models import model as model_lib
    gc.collect()
    torch.cuda.empty_cache()
    cfg = configs.get_config(arch).replace(**cut)
    t0 = time.perf_counter()
    params = model_lib.init_lm(
        cfg, generator=torch.Generator(device="cuda").manual_seed(args.seed),
        device="cuda")
    torch.cuda.synchronize()
    n = sum(p.numel() for p in params.parameters())
    log(f"{arch}: full CONFIG ({cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab} padded to {cfg.padded_vocab}): "
        f"{n} parameters in {cfg.dtype} ({n * 2} B), random from seed "
        f"{args.seed}, {time.perf_counter() - t0:.2f} s; reduced: "
        + (", ".join(f"{k} {getattr(configs.get_config(arch), k)} -> {v}"
                     for k, v in cut.items()) or "nothing"))
    rng = np.random.default_rng(args.seed + 25)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab, (LM_BATCH, LM_PROMPT),
                                           dtype=np.int32), device="cuda")
    return cfg, params, prompts


def condition_attention(torch, params, cfg) -> None:
    """Rescale each attention block's ``wq`` and ``wk`` in place to the
    scale a d_model fan-in would draw them at (the reference's init takes
    the head count as their fan-in, so without qk_norm the scores have a
    std of ~170 at internvl2-1b's widths and attention is near one-hot)."""
    cq = (cfg.n_heads / cfg.d_model) ** 0.5
    ck = (cfg.n_kv_heads / cfg.d_model) ** 0.5
    with torch.no_grad():
        for blk in params.stack.blocks:
            blk.attn.wq.mul_(cq)
            blk.attn.wk.mul_(ck)


def hold_in_f32(torch, args, cfg, prompts, gen: int, what: str,
                depths) -> None:
    """The same seeded weights in f32 (the bf16 model is their rounding)
    through ``serve_batch`` at each of ``depths`` ((n_layers, hold)), held
    against the forward within LM_FORWARD_RTOL where ``hold``, else the
    figure printed. In bf16 a recurrent family's decode departs from its
    chunked forward on these random weights in both packages (WKV6 and SSD
    round their chunk products and carried states to bf16), and zamba2's
    shared attention multiplies a relative perturbation about tenfold a
    block on them (``perturbation_probe``), so its check is held at the
    depth whose nine-block product of that gain f32 rounding survives."""
    from repro_torch.models import model as model_lib
    for layers, hold in depths:
        gc.collect()
        torch.cuda.empty_cache()
        c32 = cfg.replace(dtype="float32", n_layers=layers)
        params = model_lib.init_lm(
            c32, generator=torch.Generator(device="cuda").manual_seed(
                args.seed), device="cuda")
        tok, st, peak = serve_exact(torch, c32, params, prompts, gen,
                                    f"{what} (f32, {layers} layers)", hold)
        log_serve(f"{what}: exact, f32, {layers} layers", st, peak,
                  *prompts.shape)
        del params
    gc.collect()
    torch.cuda.empty_cache()


def perturbation_probe(torch, args, cfg, s: int = 256) -> None:
    """How a relative perturbation of 1e-6 in the embeddings grows through
    zamba2's groups (f32, full width and depth, one sequence of ``s``
    tokens): the relative difference after each group's Mamba layers, of
    its shared attention's output and after the group. A diagnostic of the
    reference's init (its attention has no qk_norm and ``wq``'s fan-in is
    the head count, so scores have a std near 80), run on the port."""
    from repro_torch.models import layers as ll
    from repro_torch.models import model as model_lib
    from repro_torch.models import transformer as tf
    c32 = cfg.replace(dtype="float32")
    params = model_lib.init_lm(
        c32, generator=torch.Generator(device="cuda").manual_seed(args.seed),
        device="cuda")
    toks = torch.as_tensor(np.random.default_rng(args.seed + 30).integers(
        0, cfg.vocab, (1, s)), device="cuda")
    pos = torch.arange(s, device="cuda")[None]
    p, k = params.stack, cfg.shared_attn_every

    def rel(a, b):
        return float((a - b).norm() / a.norm())

    with torch.inference_mode():
        h = params.embedding[toks]
        noise = torch.randn(h.shape, generator=torch.Generator(
            device="cuda").manual_seed(args.seed + 31), device="cuda")
        hs = [h, h * (1 + 1e-6 * noise)]
        h0s = list(hs)
        line = []
        for gi in range(cfg.n_layers // k):
            for j in range(2):
                for i in range(gi * k, (gi + 1) * k):
                    hs[j] = tf._mamba_layer(p.blocks[i], hs[j], c32)
            after_m = rel(*hs)
            att = []
            for j in range(2):
                x = tf._shared_in(p, gi, hs[j], h0s[j])
                a = ll.attention(p.shared.attn, ll.rmsnorm(
                    x, p.shared.ln1, c32.norm_eps), c32, pos)
                x = x + a
                x = x + ll.ffn(p.shared.ffn, ll.rmsnorm(
                    x, p.shared.ln2, c32.norm_eps), c32)
                hs[j] = hs[j] + x
                att.append(a)
            line.append(f"{after_m:.1e}/{rel(*att):.1e}/{rel(*hs):.1e}")
    log("zamba2: a 1e-6 relative perturbation of the embeddings through the "
        "groups, f32 (after the Mamba layers / of the shared attention's "
        "output / after the group): " + ", ".join(line))
    del params
    gc.collect()
    torch.cuda.empty_cache()


def scan_ms(torch, fn, what: str) -> float:
    ms = event_ms(torch, fn, 3, warmup=1)
    log(f"{what}: {ms:.4f} ms a call (CUDA events, 3 back to back)")
    return ms


def zamba2_phase(torch, args) -> int:
    """zamba2-2.7b's full CONFIG (54 Mamba2 layers, the shared attention
    block every 6, d_model 2560, its published kv_pq): ``serve_batch``
    through the exact shared-attention cache (graph replays), held against
    the teacher-forced forward; then the PQ cache, whose codebooks the
    phase calibrates itself a group at a time (the reference's serve_batch
    has none for a hybrid: ROADMAP Queue 3), through ``prefill(pq_cache=)``
    and decode-graph replays, K8's launches counted from 0; graph against
    eager on both caches; K8 against its plain version at the hybrid's
    shapes; the SSD scan's device time. Returns K8's launches."""
    from repro_torch.kernels import pq_decode_kernel as pqk
    from repro_torch.launch import serve
    from repro_torch.models import model as model_lib
    from repro_torch.models import ssm
    from repro_torch.models.decode_graph import DecodeGraph
    cfg, params, prompts = full_model(torch, args, "zamba2-2.7b")
    exact_cfg, pq_cfg = cfg.replace(kv_pq=False), cfg
    b, s, gen = LM_BATCH, LM_PROMPT, REC_GEN
    n_groups = cfg.n_layers // cfg.shared_attn_every
    kv, hd, m = cfg.n_kv_heads, cfg.resolved_head_dim, cfg.resolved_kv_pq_m
    g = cfg.n_heads // kv
    tok_e, st_e, peak_e = serve_exact(torch, exact_cfg, params, prompts, gen,
                                      "zamba2 (bf16)", hold=False)
    log_serve("zamba2: exact", st_e, peak_e, b, s)
    perturbation_probe(torch, args, exact_cfg)
    hold_in_f32(torch, args, exact_cfg, prompts, gen, "zamba2",
                ((cfg.n_layers, False), (ZAMBA2_HELD_LAYERS, True)))

    # the PQ cache: codebooks from the exact prefill's shared-attention
    # K/V, a group at a time, on 2 x 256 positions (calibrate_pq_cache's
    # sample); prefill(pq_cache=...) and graph replays
    log("zamba2: pq: the phase calibrates the hybrid's codebooks itself "
        "(serve.calibrate_hybrid_codebooks: an exact prefill, then k-means "
        "a group at a time): serve_batch refuses a hybrid with kv_pq, as "
        "the reference's does (ROADMAP Queue 3)")
    t0 = time.perf_counter()
    cbs = serve.calibrate_hybrid_codebooks(
        torch.Generator().manual_seed(args.seed), params, cfg,
        prompts[:2, :256])
    torch.cuda.synchronize()
    cal_s = time.perf_counter() - t0
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lg, cache = model_lib.prefill(params, prompts, pq_cfg, max_seq=LM_MAX_SEQ,
                                  pq_cache=cbs)
    torch.cuda.synchronize()
    pre_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    graph = DecodeGraph(params, cache, pq_cfg, b)
    out = [torch.argmax(lg[:, :cfg.vocab], -1)]
    for i in range(gen - 1):
        pos = torch.full((b,), s + i, dtype=torch.int32, device="cuda")
        out.append(torch.argmax(graph.step(out[-1], pos)[:, :cfg.vocab], -1))
    tok_p = torch.stack(out, 1)
    torch.cuda.synchronize()
    dec_s = time.perf_counter() - t0
    launches = pqk.launches
    peak_p = torch.cuda.max_memory_allocated()
    need = n_groups * (gen - 1)
    log(f"zamba2: K8 launches on the PQ run: {launches} (at least "
        f"{n_groups} shared blocks x {gen - 1} decode steps = {need})")
    if launches < need:
        raise AssertionError(f"zamba2: K8 launched {launches} < {need} times")
    check_tokens(tok_p, cfg, b, gen, "zamba2: pq")
    log_serve("zamba2: pq", dict(calibrate_s=cal_s, prefill_s=pre_s,
                                 decode_s=dec_s, decode_steps=gen - 1,
                                 capture_s=graph.capture_seconds()),
              peak_p, b, s)
    del graph
    state_b = sum(cache[k].numel() * cache[k].element_size()
                  for k in ("h", "conv"))
    exact_b = 2 * n_groups * b * LM_MAX_SEQ * kv * hd * 2
    pq_b = sum(cache[k].numel() * cache[k].element_size()
               for k in cache if k.startswith("attn_"))
    log(f"zamba2: shared-attention cache bytes at max_seq {LM_MAX_SEQ}: "
        f"exact {exact_b}, pq {pq_b} (codes and codebooks; "
        f"{exact_b / pq_b:.2f}x smaller; M={m}); Mamba states {state_b} in "
        "either")
    log(f"zamba2: exact-vs-pq token agreement "
        f"{float((tok_e == tok_p).float().mean()):.4f} (random weights)")

    for what, c, pq in (("exact", exact_cfg, None), ("pq", pq_cfg, cbs)):
        graph_vs_eager(torch, params, c, prompts, pq, gen - 1,
                       f"zamba2: {what}")
    pqk.launches = launches

    # K8 at the hybrid's shapes (group 0's codes, the last decode's
    # position): head_dim 80, M 40, g 1, KV 32
    live = s + gen - 1
    q = torch.randn((b, cfg.n_heads, hd), generator=torch.Generator(
        device="cuda").manual_seed(args.seed + 26), device="cuda").to(
            torch.bfloat16)
    args_k8 = (cache["attn_k_codes"][0], cache["attn_v_codes"][0],
               cache["attn_k_cb"][0], cache["attn_v_cb"][0])
    path = k8_glue(torch, q, *args_k8, [live - 1], True)
    k8_check(torch, path, torch.bfloat16, 2048,
             f"zamba2 shapes (B={b}, Smax={LM_MAX_SEQ}, KV={kv}, g={g}, "
             f"M={m}, head_dim {hd}, {live} live), q8")
    k8_check(torch, k8_glue(torch, q, *args_k8, [live - 1], False),
             torch.bfloat16, 2048, "zamba2 shapes, f32 LUT")
    k8_check(torch, k8_inputs(torch, args.seed + 27, b=b, smax=LM_MAX_SEQ,
                              kv=kv, g=g, m=m, dsub=hd // m,
                              positions=[0, 1, 255, 256, 2047, 3000,
                                         LM_MAX_SEQ - 1, LM_MAX_SEQ + 3],
                              q8=True, dtype=torch.float32),
             torch.float32, 2048, "zamba2 shapes, f32, edges")
    pqk.launches = launches
    k8_time(torch, path, cfg, live, launches, "zamba2")
    pqk.launches = launches
    del cache, cbs, path, args_k8

    # the SSD scan at the prefill's shapes (a torch-op chain, as the
    # reference computes it in plain JAX)
    nh, shd, ds = cfg.ssm_nheads, cfg.ssm_head_dim, cfg.ssm_state
    gen_d = torch.Generator(device="cuda").manual_seed(args.seed + 28)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen_d, device="cuda")
                * scale).to(torch.bfloat16)

    xh, bm, cm = rnd(b, s, nh, shd), rnd(b, s, 1, ds), rnd(b, s, 1, ds)
    log_a = -torch.rand((b, s, nh), generator=gen_d, device="cuda") * 0.3
    scan_ms(torch, lambda: ssm.ssd_chunked(xh, log_a, bm, cm, cfg.ssm_chunk),
            f"zamba2: ssd_chunked (B={b}, S={s}, nh={nh}, hd={shd}, "
            f"ds={ds}, chunk {cfg.ssm_chunk}, bf16)")
    del xh, bm, cm, log_a, params
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def rwkv6_phase(torch, args) -> None:
    """rwkv6-3b's full CONFIG at every published width and depth, with
    ``rwkv_chunk`` 128 -> 32 (it tiles the scan and is no width; at 128 the
    reference's WKV6 overflows f32 on these weights, ROADMAP Queue 3):
    ``serve_batch`` (graph replays) held against the teacher-forced
    forward, graph against eager, one prefill at the published chunk 128
    (are its logits finite?), and WKV6's device time at both chunks."""
    from repro_torch.models import model as model_lib
    from repro_torch.models import rwkv6
    cfg, params, prompts = full_model(torch, args, "rwkv6-3b",
                                           rwkv_chunk=32)
    b, s, gen = LM_BATCH, LM_PROMPT, REC_GEN
    tok, st, peak = serve_exact(torch, cfg, params, prompts, gen,
                                "rwkv6 (bf16)", hold=False)
    log_serve("rwkv6", st, peak, b, s)
    hold_in_f32(torch, args, cfg, prompts, gen, "rwkv6",
                ((cfg.n_layers, True),))
    _, cache = model_lib.prefill(params, prompts, cfg)
    log(f"rwkv6: state bytes {sum(t.numel() * t.element_size() for t in cache.values())}"
        " (s, tm_prev, cm_prev; no KV cache: the paper's technique does not "
        "apply)")
    del cache
    graph_vs_eager(torch, params, cfg, prompts, None, gen - 1, "rwkv6")
    published = cfg.replace(rwkv_chunk=128)
    lg, _ = model_lib.prefill(params, prompts, published)
    finite = bool(torch.isfinite(lg).all())
    log(f"rwkv6: prefill at the published rwkv_chunk 128: logits "
        f"{'finite' if finite else 'NOT finite'} ({int((~torch.isfinite(lg)).sum())}"
        f" of {lg.numel()} non-finite; the reference forms k * exp(-a) alike: "
        "ROADMAP Queue 3)")
    nh, hd = cfg.rwkv_nheads, cfg.rwkv_head_dim
    gen_d = torch.Generator(device="cuda").manual_seed(args.seed + 29)
    r, k, v = ((torch.randn((b, s, nh, hd), generator=gen_d, device="cuda")
                * 0.5).to(torch.bfloat16) for _ in range(3))
    log_w = -torch.rand((b, s, nh, hd), generator=gen_d, device="cuda") * 0.3
    u = params.stack.blocks[0].rwkv.u
    for chunk in (32, 128):
        scan_ms(torch, lambda: rwkv6.wkv6_chunked(r, k, v, log_w, u, chunk),
                f"rwkv6: wkv6_chunked (B={b}, S={s}, nh={nh}, hd={hd}, chunk "
                f"{chunk}, bf16)")
    del params, r, k, v, log_w
    gc.collect()
    torch.cuda.empty_cache()


def serve_pq(torch, args, cfg, params, prompts, gen: int, what: str,
             per_step: int):
    """``serve_batch`` through the PQ cache (calibrated codebooks, graph
    replays), K8's launches counted from 0 and held to at least
    ``per_step`` x the decode steps. Returns (launches, tokens, stats,
    peak memory)."""
    from repro_torch.kernels import pq_decode_kernel as pqk
    from repro_torch.launch import serve
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    st = {}
    tok = serve.serve_batch(cfg, params, prompts, gen, max_seq=LM_MAX_SEQ,
                            generator=torch.Generator().manual_seed(
                                args.seed), stats=st)
    torch.cuda.synchronize()
    launches, peak = pqk.launches, torch.cuda.max_memory_allocated()
    need = per_step * (gen - 1)
    log(f"{what}: K8 launches on the PQ run: {launches} (at least "
        f"{per_step} layers x {gen - 1} decode steps = {need}; the graph's "
        "eager warm-up adds one step's)")
    if launches < need:
        raise AssertionError(f"{what}: K8 launched {launches} < {need} times")
    check_tokens(tok, cfg, *prompts.shape[:1], gen, f"{what}: pq")
    log_serve(f"{what}: pq", st, peak, *prompts.shape)
    return launches, tok, st, peak


def k8_at_path(torch, args, cfg, params, prompts, gen: int, launches: int,
               what: str) -> dict:
    """K8 against its plain version at an attention model's PQ shapes
    (layer 0 of a prefilled PQ cache, the last decode's position; both LUT
    kinds, bf16) and at edges of its positions (f32), then timed beside its
    bound. Leaves K8's count at ``launches``; returns the figures."""
    from repro_torch.kernels import pq_decode_kernel as pqk
    from repro_torch.launch import serve
    from repro_torch.models import model as model_lib
    pq_cfg = cfg.replace(kv_pq=True)
    b, s = prompts.shape
    kv, hd, m = cfg.n_kv_heads, cfg.resolved_head_dim, cfg.resolved_kv_pq_m
    g = cfg.n_heads // kv
    pqc = serve.calibrate_pq_cache(torch.Generator().manual_seed(args.seed),
                                   params, pq_cfg, b, LM_MAX_SEQ)
    _, cache = model_lib.prefill(params, prompts, pq_cfg, max_seq=LM_MAX_SEQ,
                                 pq_cache=pqc)
    live = s + gen - 1
    q = torch.randn((b, cfg.n_heads, hd), generator=torch.Generator(
        device="cuda").manual_seed(args.seed + 60), device="cuda").to(
            torch.bfloat16)
    layer0 = (cache.k_codes[0], cache.v_codes[0], cache.k_cb[0],
              cache.v_cb[0])
    path = k8_glue(torch, q, *layer0, [live - 1], True)
    shape = (f"B={b}, Smax={LM_MAX_SEQ}, KV={kv}, g={g}, M={m}, head_dim "
             f"{hd}, {live} live")
    err = k8_check(torch, path, torch.bfloat16, 2048,
                   f"{what} shapes ({shape}), q8")
    k8_check(torch, k8_glue(torch, q, *layer0, [live - 1], False),
             torch.bfloat16, 2048, f"{what} shapes, f32 LUT")
    k8_check(torch, k8_inputs(torch, args.seed + 61, b=b, smax=LM_MAX_SEQ,
                              kv=kv, g=g, m=m, dsub=hd // m,
                              positions=[0, 1, 255, 256, 2047, 3000,
                                         LM_MAX_SEQ - 1, LM_MAX_SEQ + 3],
                              q8=True, dtype=torch.float32),
             torch.float32, 2048, f"{what} shapes, f32, edges")
    pqk.launches = launches
    ms, plain_ms, bound, by = k8_time(torch, path, cfg, live, launches, what)
    pqk.launches = launches
    del cache, pqc, path, layer0
    return dict(path=what, shape=shape, launches=launches, max_abs_err=err,
                ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by)


def embeds_check(torch, args, cfg, params, prompts, what: str) -> None:
    """The frontend stub on the card: seeded (B, frontend_len, D)
    embeddings (at the token table's scale) through ``forward`` and the
    exact ``prefill``. Equal embeddings give equal logits bit for bit; a
    change at the last embedded position leaves every earlier position bit
    for bit as it was and moves its own (causal); against the forward
    without them, every embedded position moves; the prefill's last
    logits are the forward's within LM_FORWARD_RTOL of max |logit|, with
    and without them."""
    from repro_torch.models import model as model_lib
    f = cfg.frontend_len
    gen = torch.Generator(device="cuda").manual_seed(args.seed + 50)
    emb = (torch.randn((prompts.shape[0], f, cfg.d_model), generator=gen,
                       device="cuda")
           * params.embedding.float().std()).to(torch.bfloat16)
    t0 = time.perf_counter()
    with_e, _ = model_lib.forward(params, prompts, cfg, frontend_embeds=emb)
    again, _ = model_lib.forward(params, prompts, cfg, frontend_embeds=emb)
    same = bool(torch.equal(with_e, again))
    del again
    moved_emb = emb.clone()
    moved_emb[:, -1] = moved_emb[:, -1] * 2 + 0.01
    moved, _ = model_lib.forward(params, prompts, cfg,
                                 frontend_embeds=moved_emb)
    before = bool(torch.equal(moved[:, :f - 1], with_e[:, :f - 1]))
    at = bool((moved[:, f - 1] != with_e[:, f - 1]).any(-1).all())
    after = float((moved[:, f:] != with_e[:, f:]).any(-1).float().mean())
    del moved
    plain, _ = model_lib.forward(params, prompts, cfg)
    differ = (plain != with_e).any(-1)
    embedded = bool(differ[:, :f].all())
    every = float(differ[:, f:].float().mean())
    top = float(with_e.abs().max())
    rel = []
    for e, full in ((emb, with_e), (None, plain)):
        lg, _ = model_lib.prefill(params, prompts, cfg, max_seq=LM_MAX_SEQ,
                                  frontend_embeds=e)
        rel.append(float((lg.float() - full[:, -1].float()).abs().max())
                   / top)
    del with_e, plain
    torch.cuda.synchronize()
    log(f"{what}: frontend stub, {f} embedded positions of {prompts.shape[1]}"
        f" ({time.perf_counter() - t0:.2f} s): equal embeddings equal "
        f"logits {same}; a change at position {f - 1} leaves positions 0-"
        f"{f - 2} bit for bit {before}, moves its own {at} and {after:.4f} "
        f"of the later (row, position)s; against no embeddings the "
        f"embedded positions all move {embedded}, and {every:.4f} of the "
        f"later ones (attention on these random weights is near one-hot, "
        f"so a later position moves where it attends to one: a figure); "
        f"prefill's last logits vs the forward's: {rel[0]:.3e} with, "
        f"{rel[1]:.3e} without (of max |logit|, tolerance "
        f"{LM_FORWARD_RTOL})")
    if not (same and before and at and embedded
            and max(rel) < LM_FORWARD_RTOL):
        raise AssertionError(f"{what}: the frontend stub check failed")


def frontend_phase(torch, args) -> list[dict]:
    """The frontend archs whole (internvl2-1b: 24 layers, GQA 14/2 x 64,
    qkv_bias, vocab 151,655; musicgen-medium: 48 layers, MHA 24 x 64,
    gelu, vocab 2,048) in bf16 on seeded weights: their stubs' embeddings
    through ``forward`` and the exact ``prefill`` (``embeds_check``); then
    ``serve_batch`` (from tokens alone, as the reference's serves them)
    through the exact cache and the PQ cache through K8; graph against
    eager on both; K8 against its plain version at each arch's shapes.
    On the reference's init neither backbone's attention is normalized
    (no qk_norm, ``wq``/``wk`` drawn at a head-count fan-in), so it is
    near one-hot and rounding flips which key wins: the decode against
    the teacher-forced forward is printed there as a figure, and held
    within LM_FORWARD_RTOL on the same weights with the attention
    conditioned (``condition_attention``). Returns K8's figures a path."""
    from repro_torch.launch import serve
    out = []
    for arch in FRONTEND_ARCHS:
        t0 = time.perf_counter()
        cfg, params, prompts = full_model(torch, args, arch)
        what = arch.split("-")[0]
        embeds_check(torch, args, cfg, params, prompts, what)
        exact_cfg, pq_cfg = cfg.replace(kv_pq=False), cfg.replace(kv_pq=True)
        _, st, peak = serve_exact(torch, exact_cfg, params, prompts,
                                  FRONTEND_GEN, f"{what} (bf16)", hold=False)
        log_serve(f"{what}: exact", st, peak, *prompts.shape)
        launches = serve_pq(torch, args, pq_cfg, params, prompts,
                            FRONTEND_GEN, what, cfg.n_layers)[0]
        pqc = serve.calibrate_pq_cache(
            torch.Generator().manual_seed(args.seed), params, pq_cfg,
            LM_BATCH, LM_MAX_SEQ)
        for kind, c, pq in (("exact", exact_cfg, None), ("pq", pq_cfg, pqc)):
            graph_vs_eager(torch, params, c, prompts, pq, FRONTEND_GEN - 1,
                           f"{what}: {kind}")
        del pqc
        out.append(k8_at_path(torch, args, cfg, params, prompts,
                              FRONTEND_GEN, launches, what))
        # the held check, on the same weights with the attention conditioned
        condition_attention(torch, params, cfg)
        serve_exact(torch, exact_cfg, params, prompts, FRONTEND_GEN,
                    f"{what} (bf16, attention conditioned)")
        del params
        gc.collect()
        torch.cuda.empty_cache()
        log(f"{what}: phase {time.perf_counter() - t0:.1f} s")
    return out


def drop_share(torch, params, prompts, cfg) -> list[float]:
    """Each MoE layer's share of (token, k) entries dropped at the exact
    prefill of ``prompts`` under ``cfg``'s capacity (``moe.route`` wrapped
    for the one call)."""
    from repro_torch.models import model as model_lib
    from repro_torch.models import moe
    kept, route = [], moe.route

    def recording(gates_all, c):
        r = route(gates_all, c)
        kept.append(r.keep_tok.float().mean())
        return r

    moe.route = recording
    try:
        model_lib.prefill(params, prompts, cfg, max_seq=LM_MAX_SEQ)
    finally:
        moe.route = route
    return [1.0 - float(k) for k in kept]


def moe_phase(torch, args) -> list[dict]:
    """The MoE archs at every published width (d_model, heads, d_ff,
    n_experts, top-k, capacity_factor 1.25, moe_groups 32) with the depth
    cut to ``configs.ONE_CARD_LAYERS`` (logged as a reduction: the whole
    models hold 263 and 216 GB in bf16), seeded weights, B = 8 prompts of 2,048 tokens:
    the prefill's drop share under the published capacity (none at the
    check-only capacity E / k); ``serve_batch`` through the exact cache
    at the published capacity (its decode against the forward a figure:
    the forward groups S + gen tokens otherwise, and so drops otherwise;
    and the attention is near one-hot, as ``frontend_phase`` says) and
    through the PQ cache (K8); graph against eager on both caches; the
    decode step beside its byte bound (every expert's weights are read a
    step, as the reference's expert FFN runs every expert over its
    capacity slots); K8 at the path's shapes; then the exact decode held
    against the forward within LM_FORWARD_RTOL at the check-only capacity,
    where no token drops at any grouping, with the attention conditioned.
    Frees each model before the next. Returns K8's figures a path."""
    from repro_torch import configs
    from repro_torch.launch import serve
    out = []
    for arch, layers in configs.ONE_CARD_LAYERS.items():
        t0 = time.perf_counter()
        cfg, params, prompts = full_model(torch, args, arch, n_layers=layers)
        what = arch.split("-")[0]
        e, k = cfg.n_experts, cfg.n_experts_active
        exact_cfg, pq_cfg = cfg.replace(kv_pq=False), cfg.replace(kv_pq=True)
        check_cfg = exact_cfg.replace(capacity_factor=float(e // k))
        weights = sum(p.numel() * p.element_size()
                      for p in params.parameters())
        experts = sum(p.numel() * p.element_size()
                      for n, p in params.named_parameters()
                      if ".moe.w" in n)
        log(f"{what}: {cfg.n_layers} layers at full width, {e} experts top-{k}, capacity_factor {cfg.capacity_factor}, "
            f"moe_groups {cfg.moe_groups}: weights {weights} B (routed "
            f"experts {experts} B); torch.cuda.memory_allocated "
            f"{torch.cuda.memory_allocated()} B")
        t1 = time.perf_counter()
        drops = drop_share(torch, params, prompts, exact_cfg)
        no_drops = drop_share(torch, params, prompts, check_cfg)
        log(f"{what}: prefill drop share under the published capacity "
            f"(B x S = {prompts.numel()} tokens, {layers} layers): mean "
            f"{np.mean(drops):.4f}, per layer {min(drops):.4f}-"
            f"{max(drops):.4f}; at the check-only capacity_factor "
            f"{check_cfg.capacity_factor}: {max(no_drops):.4f} "
            f"[{time.perf_counter() - t1:.1f} s]")
        if max(no_drops) != 0.0:
            raise AssertionError(f"{what}: tokens dropped at capacity E/k")
        _, st, peak = serve_exact(torch, exact_cfg, params, prompts, MOE_GEN,
                                  f"{what} (bf16, published capacity)",
                                  hold=False)
        log_serve(f"{what}: exact", st, peak, *prompts.shape)
        launches = serve_pq(torch, args, pq_cfg, params, prompts, MOE_GEN,
                            what, cfg.n_layers)[0]
        pqc = serve.calibrate_pq_cache(
            torch.Generator().manual_seed(args.seed), params, pq_cfg,
            LM_BATCH, LM_MAX_SEQ)
        steps = {}
        for kind, c, pq in (("exact", exact_cfg, None), ("pq", pq_cfg, pqc)):
            steps[kind] = graph_vs_eager(torch, params, c, prompts, pq,
                                         MOE_GEN - 1, f"{what}: {kind}")
        del pqc
        live = prompts.shape[1] + MOE_GEN - 1
        kv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
        cache_b = {"exact": 2 * layers * LM_BATCH * live * kv * hd * 2,
                   "pq": 2 * layers * LM_BATCH * live * kv
                   * (cfg.resolved_kv_pq_m // 2)}
        for kind, st_g in steps.items():
            nbytes = weights + cache_b[kind] + LM_BATCH * cfg.padded_vocab * 2
            bound = nbytes / rl.HBM_BW * 1e3
            log(f"{what}: {kind} decode step {st_g['graph_ms']:.3f} ms "
                f"(graph; device {st_g['graph']['busy']:.3f} ms) against a "
                f"byte bound of {bound:.3f} ms ({nbytes} B: every weight "
                f"once, {experts} B of them routed experts, and the cache's "
                f"{live} live positions): {st_g['graph_ms'] / bound:.2f}x")
        out.append(k8_at_path(torch, args, cfg, params, prompts, MOE_GEN,
                              launches, what))
        # the held check: the check-only capacity, the attention conditioned
        condition_attention(torch, params, cfg)
        _, st_c, peak_c = serve_exact(
            torch, check_cfg, params, prompts, MOE_GEN,
            f"{what} (bf16, check-only capacity_factor "
            f"{check_cfg.capacity_factor}, attention conditioned)")
        log_serve(f"{what}: exact, check-only capacity", st_c, peak_c,
                  *prompts.shape)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        log(f"{what}: phase {time.perf_counter() - t0:.1f} s")
    return out


# the training phase: qwen3-1.7b whole at its published remat and
# loss_chunk, a global batch of TRAIN_BATCH x TRAIN_SEQ tokens from the
# token pipeline (seed 0) in TRAIN_MICRO microbatches, TRAIN_STEPS steps
# of a cosine schedule warming up over 2, a checkpoint after
# TRAIN_CKPT_STEP and a resume from it; then one step each of the
# recurrent archs at TRAIN_REC_BATCH x TRAIN_SEQ
TRAIN_ARCH = "qwen3-1.7b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO = 8, 2048, 2
TRAIN_STEPS, TRAIN_CKPT_STEP, TRAIN_REC_BATCH = 8, 4, 2
TRAIN_REC = (("zamba2-2.7b", {}), ("rwkv6-3b", {"rwkv_chunk": 32}))
# the codec's relative reconstruction error on a leaf that every token's
# gradient reaches must stay under the reference's own bound in its test
# (tests/test_train.py, Gaussian gradients); the vocab-indexed leaves'
# gradients are row-sparse (the embedding's rows of the batch's tokens
# only, the head's heavy on the frequent tokens), which a 16-codeword
# codebook fitted on 4,096 sampled rows spends on the near-zero bulk:
# their error is printed as a figure
CODEC_REL_MAX = 0.9
VOCAB_LEAVES = ("embedding", "lm_head")

def train_steps(torch, step_fn, state, batches, first: int, what: str,
                flops: float, on_step=None):
    """Run ``batches`` through ``step_fn`` from step ``first`` (1-based),
    each synchronised and timed; return (state, the records)."""
    recs = []
    for i, batch in enumerate(batches, start=first):
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        rec = {"step": i, "s": dt, "loss": m["loss"].clone(),
               **{k: float(m[k]) for k in ("ce", "grad_norm", "lr")}}
        tokens = batch["tokens"].numel()
        log(f"{what}: step {i} {dt * 1e3:.1f} ms, {tokens / dt:.0f} tokens/s,"
            f" model-FLOP share {flops / dt / rl.PEAK_FLOPS:.4f}, loss "
            f"{float(rec['loss']):.6f} (ce {rec['ce']:.6f}), grad_norm "
            f"{rec['grad_norm']:.4f}, lr {rec['lr']:.3e}; peak memory "
            f"{torch.cuda.max_memory_allocated()} B")
        if not (np.isfinite(float(rec["loss"]))
                and np.isfinite(rec["grad_norm"])):
            raise AssertionError(f"{what}: step {i} is not finite: {rec}")
        recs.append(rec)
        if on_step is not None:
            on_step(i, state)
    return state, recs


def host_bits(torch, state) -> dict:
    """A training state's tensors (params, mu, nu, step; a DTensor taken
    whole) copied to the host as integers of their width, so that
    equality is of bits."""
    ints = {2: torch.int16, 4: torch.int32}
    named = [*(("params." + n, p) for n, p in state.params.named_parameters()),
             *(("mu." + n, t) for n, t in state.opt.mu.items()),
             *(("nu." + n, t) for n, t in state.opt.nu.items()),
             ("step", state.opt.step)]
    return {n: (t.full_tensor() if hasattr(t, "full_tensor") else t)
            .detach().view(ints[t.element_size()]).cpu() for n, t in named}


def codec_check(torch, args, cfg, params, batch) -> None:
    """Step 1's gradients of the whole model timed, then again under the
    profiler (device ms, ops, the largest kernels), then the 4-bit PQ
    gradient codec
    (``train.grad_compress.ef_step``, zero error state) once over them: its
    ratio, its ms, and the relative reconstruction error of the largest
    leaves and of all of them; each leaf finite and its new error state
    the gradient less its decoding, and each leaf but VOCAB_LEAVES under
    CODEC_REL_MAX. Returns the profiled gradients' device ops."""
    from repro_torch.train import grad_compress as gc_lib
    from repro_torch.train import train_loop
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    train_loop.accumulate_grads(params, batch, cfg, TRAIN_MICRO)
    torch.cuda.synchronize()
    grads_ms = (time.perf_counter() - t0) * 1e3
    out = {}
    wall, busy, ops, rows = breakdown(torch, lambda: out.update(
        g=train_loop.accumulate_grads(params, batch, cfg, TRAIN_MICRO)))
    grads = out.pop("g")[0]
    log(f"train: step 1's gradients ({TRAIN_MICRO} microbatches, forward, "
        f"remat forward and backward) {grads_ms:.1f} ms; profiled: "
        f"{wall:.1f} ms wall, device {busy:.1f} ms in {ops} ops, idle "
        f"{1 - busy / grads_ms:.3f} of the unprofiled time; "
        + ", ".join(f"{k[:60]} {ms:.1f}" for k, ms in rows[:10]))
    error = gc_lib.init_error(grads)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dec, new_err, stats = gc_lib.ef_step(
        torch.Generator().manual_seed(args.seed), grads, error,
        gc_lib.PQGradCodec())
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    rel = {n: float(torch.linalg.vector_norm(dec[n] - g)
                    / torch.linalg.vector_norm(g)) for n, g in grads.items()}
    num = sum(float(torch.linalg.vector_norm(dec[n] - g)) ** 2
              for n, g in grads.items())
    den = sum(float(torch.linalg.vector_norm(g)) ** 2 for g in grads.values())
    largest = sorted(grads, key=lambda n: -grads[n].numel())[:4]
    log(f"train: codec (dsub 4, 16 codewords, k-means 5 iterations on 4,096 "
        f"rows a leaf) over step 1's f32 gradients, {len(grads)} leaves: "
        f"{stats['raw_bytes']} B -> {stats['compressed_bytes']} B, ratio "
        f"{stats['ratio']:.3f}, {ms:.1f} ms; relative error of all leaves "
        f"{(num / den) ** 0.5:.4f}, of the largest "
        + ", ".join(f"{n} {tuple(grads[n].shape)} {rel[n]:.4f}"
                    for n in largest)
        + "; worst of the other leaves "
        + str(max(r for n, r in rel.items() if n not in VOCAB_LEAVES)))
    bad = {n: r for n, r in rel.items()
           if not (r < CODEC_REL_MAX or n in VOCAB_LEAVES and r < 1.0)}
    bad.update({n: "error state" for n, g in grads.items()
                if not (torch.isfinite(dec[n]).all()
                        and torch.equal(new_err[n], g - dec[n]))})
    if bad:
        raise AssertionError(f"train: codec leaves out of bounds: "
                             f"{sorted(bad.items())[:5]}")
    del grads, error, dec, new_err
    return ops


def train_phase(torch, args, root: str) -> None:
    """LM training on the card at full width and depth (see the module
    docstring, item 12): qwen3-1.7b's TRAIN_STEPS steps with the loss
    falling, the codec over step 1's gradients, a checkpoint after step
    TRAIN_CKPT_STEP written while steps go on, a resume from it equal to
    the uninterrupted run bit for bit (deterministic algorithms: needs
    ``CUBLAS_WORKSPACE_CONFIG`` set before the first cuBLAS call, as
    ``main`` sets it), then one step each of zamba2-2.7b and rwkv6-3b."""
    from repro_torch import configs
    from repro_torch.data import tokens as tok
    from repro_torch.train import checkpoint as ckpt_lib
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import train_loop
    dev = torch.device("cuda")
    gc.collect()
    torch.cuda.empty_cache()
    cfg = configs.get_config(TRAIN_ARCH)
    ocfg = opt_lib.AdamWConfig(total_steps=TRAIN_STEPS, warmup_steps=2)
    pipe = tok.TokenPipelineConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                   global_batch=TRAIN_BATCH, seed=0)
    batches = [dict(tok.batch_at_step(pipe, s, dev)._asdict())
               for s in range(TRAIN_STEPS)]
    t0 = time.perf_counter()
    state = train_loop.init_train_state(cfg, args.seed, dev)
    torch.cuda.synchronize()
    n = sum(p.numel() for p in state.params.parameters())
    n_model = n - state.params.embedding.numel()
    # the model FLOPs of a step by the reference's accounting
    # (6 x active parameters x tokens and the causal attention term);
    # the earlier yardstick, 6 x non-embedding parameters x tokens, printed once
    # beside it
    flops = rl.model_flops(cfg, "train", TRAIN_BATCH, TRAIN_SEQ)
    flops_6n = 6 * n_model * TRAIN_BATCH * TRAIN_SEQ
    state_b = sum(t.numel() * t.element_size() for t in
                  [*state.params.parameters(), *state.opt.mu.values(),
                   *state.opt.nu.values()])
    log(f"train: {cfg.name} full CONFIG ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, vocab {cfg.vocab}), {cfg.dtype}, remat {cfg.remat}, "
        f"loss_chunk {cfg.loss_chunk}: {n} parameters; model FLOPs a step "
        f"{flops:.4e} (roofline.model_flops; 6 x the {n_model} non-embedding "
        f"parameters x {TRAIN_BATCH * TRAIN_SEQ} tokens would be "
        f"{flops_6n:.4e}), random from seed {args.seed}; "
        f"params + moments {state_b} B; batch {TRAIN_BATCH} x {TRAIN_SEQ} "
        f"in {TRAIN_MICRO} microbatches; AdamW {dict(ocfg._asdict())} "
        f"[{time.perf_counter() - t0:.1f} s]; reduced: nothing")
    grad_ops = codec_check(torch, args, cfg, state.params, batches[0])
    gc.collect()
    torch.cuda.empty_cache()

    ckpt_dir = os.path.join(root, "build", "chip_smoke_train_ckpt")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    free = shutil.disk_usage(os.path.join(root, "build")).free
    log(f"train: {free} B free on the checkpoint's disk; the state is "
        f"{state_b} B")
    step_fn = train_loop.make_train_step(cfg, ocfg, TRAIN_MICRO)
    ckptr = ckpt_lib.AsyncCheckpointer(ckpt_dir, keep=1)
    saved = {}

    def checkpoint(i, st):
        if i == TRAIN_CKPT_STEP:
            t = time.perf_counter()
            ckptr.save(i, st)
            saved.update(snapshot_s=time.perf_counter() - t,
                         returned=time.time())

    torch.use_deterministic_algorithms(True)
    try:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        static_real = ca.tree_bytes(state.params, state.opt)
        torch.cuda.reset_peak_memory_stats()
        state, recs = train_steps(torch, step_fn, state, batches, 1,
                                  "train", flops, checkpoint)
        peak = torch.cuda.max_memory_allocated()
        MEASURED["train"] = dict(
            cfg=cfg, batch=TRAIN_BATCH, seq=TRAIN_SEQ, micro=TRAIN_MICRO,
            step_s=float(np.median([r["s"] for r in recs[1:]])),
            static_real=static_real, step_peak=peak - base,
            inputs=ca.tree_bytes(batches[0]), grad_ops=grad_ops)
        t = time.perf_counter()
        ckptr.wait()
        wait_s = time.perf_counter() - t
        step_dir = os.path.join(ckpt_dir, f"step_{TRAIN_CKPT_STEP:08d}")
        nbytes = sum(os.path.getsize(os.path.join(step_dir, f))
                     for f in os.listdir(step_dir))
        write_s = (os.path.getmtime(os.path.join(step_dir, ckpt_lib.MANIFEST))
                   - saved["returned"])
        steady = [r["s"] for r in recs[1:]]
        log(f"train: {TRAIN_STEPS} steps, loss {float(recs[0]['loss']):.6f} "
            f"-> {float(recs[-1]['loss']):.6f}; step s median "
            f"{np.median(steady):.4f} (steps 2-{TRAIN_STEPS}; step 1 "
            f"{recs[0]['s']:.4f}), {TRAIN_BATCH * TRAIN_SEQ / np.median(steady):.0f} "
            f"tokens/s, model-FLOP share {flops / np.median(steady) / rl.PEAK_FLOPS:.4f} "
            f"of {rl.PEAK_FLOPS:.3e}; peak memory {peak} B")
        log(f"train: checkpoint of step {TRAIN_CKPT_STEP}: {nbytes} B, the "
            f"host snapshot {saved['snapshot_s']:.2f} s, written "
            f"{write_s:.2f} s after it (overlapping steps "
            f"{TRAIN_CKPT_STEP + 1}-{TRAIN_STEPS}), wait after step "
            f"{TRAIN_STEPS} {wait_s:.2f} s")
        if not float(recs[-1]["loss"]) < float(recs[0]["loss"]):
            raise AssertionError(f"train: the loss did not fall: "
                                 f"{[float(r['loss']) for r in recs]}")
        t = time.perf_counter()
        final = host_bits(torch, state)
        log(f"train: the uninterrupted state to the host "
            f"{time.perf_counter() - t:.2f} s")
        del state, step_fn
        gc.collect()
        torch.cuda.empty_cache()
        # a fresh state from another seed, so that the restore must
        # overwrite every tensor
        fresh = train_loop.init_train_state(cfg, args.seed + 1, dev)
        t = time.perf_counter()
        step, fresh = ckpt_lib.restore(ckpt_dir, fresh)
        torch.cuda.synchronize()
        log(f"train: restored step {step} in {time.perf_counter() - t:.2f} s")
        if step != TRAIN_CKPT_STEP or int(fresh.opt.step) != step:
            raise AssertionError(f"train: restored step {step}, opt step "
                                 f"{int(fresh.opt.step)}")
        fresh, again = train_steps(
            torch, train_loop.make_train_step(cfg, ocfg, TRAIN_MICRO), fresh,
            batches[TRAIN_CKPT_STEP:], TRAIN_CKPT_STEP + 1, "train resumed",
            flops)
        same_loss = all(torch.equal(a["loss"], b["loss"]) for a, b in
                        zip(recs[TRAIN_CKPT_STEP:], again))
        resumed = host_bits(torch, fresh)
        differ = sorted(k for k in final
                        if not torch.equal(final[k], resumed.get(k)))
        log(f"train: resume from step {TRAIN_CKPT_STEP}: losses of steps "
            f"{TRAIN_CKPT_STEP + 1}-{TRAIN_STEPS} equal bit for bit: "
            f"{same_loss}; {len(final) - len(differ)} of {len(final)} "
            f"tensors (params, mu, nu, step) equal bit for bit")
        if differ or not same_loss or set(final) != set(resumed):
            raise AssertionError(f"train: the resume differs: {differ[:5]}")
    finally:
        torch.use_deterministic_algorithms(False)
    del fresh, final, resumed, batches
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()

    for arch, cut in TRAIN_REC:
        rcfg = configs.get_config(arch).replace(**cut)
        state = train_loop.init_train_state(rcfg, args.seed, dev)
        n = sum(p.numel() for p in state.params.parameters())
        rpipe = tok.TokenPipelineConfig(vocab=rcfg.vocab, seq_len=TRAIN_SEQ,
                                        global_batch=TRAIN_REC_BATCH, seed=0)
        batch = dict(tok.batch_at_step(rpipe, 0, dev)._asdict())
        rflops = rl.model_flops(rcfg, "train", TRAIN_REC_BATCH, TRAIN_SEQ)
        log(f"train: {arch} full CONFIG ({rcfg.n_layers} layers, d_model "
            f"{rcfg.d_model}), {n} parameters in {rcfg.dtype}, remat "
            f"{rcfg.remat}; reduced: "
            + (", ".join(f"{k} {getattr(configs.get_config(arch), k)} -> {v}"
                         for k, v in cut.items()) or "nothing"))
        torch.cuda.reset_peak_memory_stats()
        state, _ = train_steps(
            torch, train_loop.make_train_step(rcfg, ocfg, 1), state, [batch],
            1, f"train {arch.split('-')[0]}", rflops)
        del state, batch
        gc.collect()
        torch.cuda.empty_cache()


# the dry-run phase: the paths the LM and training phases measured, each
# counted again on the meta device (repro_torch.launch.dryrun) at the same
# shapes, cut and cache. The decode paths: (their name in MEASURED, K8
# launches a step the count must hold: one a PQ attention layer, none on
# an exact cache)
DRYRUN_DECODE = (("lm: exact", 0), ("lm: pq", 28), ("zamba2: pq", 9),
                 ("dbrx: exact", 0))
# a measured time below this share of the count's t_bound means the count
# overstates the work
DRYRUN_TIME_FLOOR = 0.95
# counted peak of live bytes / the step's measured peak (its parameters,
# state and cache, its inputs, and its max_memory_allocated above what was
# allocated before it). The counter follows each storage's life exactly;
# the two part by the caching allocator's rounding (a block rounded up to
# 512 B, a large one by up to 1 MB it does not split), CUDA-only
# temporaries (K8's split workspace, the deterministic embedding
# backward's sort) and the order in which the card's autograd engine frees
# saved tensors: 0.9998-1.0048 on these five paths (NVIDIA H100 80GB
# HBM3, 700 W)
DRYRUN_PEAK_BAND = (0.98, 1.02)


def dryrun_phase(torch) -> None:
    """The dry-run's count of the qwen3-1.7b exact and PQ decode steps,
    zamba2-2.7b's PQ step, dbrx-132b's step at its one-card depth and
    qwen3's training step (2 microbatches), at the shapes the earlier
    phases ran them, held against what those phases measured: the
    measured time (the decode graph's replay by CUDA events; the training
    step synchronised) never below DRYRUN_TIME_FLOOR x t_bound, the static
    bytes equal to the real tensors', the peak within DRYRUN_PEAK_BAND,
    every K8 launch of a PQ step counted. Prints the counted FLOPs, bytes,
    ops (beside the profiler's), the model-FLOP share of each path
    (``roofline.model_flops``) and the largest ops by bytes."""
    from repro_torch.launch import dryrun
    bad = []
    paths = [(what, "decode", k8) for what, k8 in DRYRUN_DECODE]
    paths.append(("train", "train", 0))
    for what, kind, k8_need in paths:
        m = MEASURED[what]
        cfg = m["cfg"]
        t0 = time.perf_counter()
        if kind == "train":
            b, seq = m["batch"], m["seq"]
            costs = dryrun.count_cell(cfg, kind, b, seq,
                                      microbatches=m["micro"])
            ms = m["step_s"] * 1e3
            measured_ops = f"{m['grad_ops']} device ops in the gradients"
        else:
            b, seq = m["batch"], m["live"]
            costs = dryrun.count_cell(cfg, kind, b, m["smax"], live=seq)
            ms = m["replay_ms"]
            measured_ops = f"{m['eager']['ops']} device ops an eager step"
        trace_s = time.perf_counter() - t0
        roof = dryrun.roofline(cfg, cfg.name, what, kind, b, seq, costs)
        bound = roof.t_bound * 1e3
        peak_real = m["static_real"] + m.get("inputs", 0) + m["step_peak"]
        ratio = costs.peak_live_bytes / peak_real
        k8 = costs.kernels.get("pq_decode_attention", 0)
        log(f"dryrun: {what} ({cfg.name}, {cfg.n_layers} layers, {kind}, B "
            f"{b}, {'seq' if kind == 'train' else 'live'} {seq}; counted on "
            f"meta in {trace_s:.1f} s): {costs.flops:.6e} FLOPs, min_bytes "
            f"{costs.min_bytes}, op_bytes {costs.op_bytes:.6e}, t_bound "
            f"{bound:.4f} ms ({roof.bottleneck}); measured {ms:.4f} ms = "
            f"{ms / bound:.3f}x t_bound; model-FLOP share "
            f"{roof.model_flops_total / (ms * 1e-3) / rl.PEAK_FLOPS:.6f} "
            f"({roof.model_flops_total:.6e} model FLOPs)")
        log(f"dryrun: {what}: static_bytes {costs.static_bytes} against the "
            f"real tensors' {m['static_real']}; peak_live_bytes "
            f"{costs.peak_live_bytes} (the card holds "
            f"{rl.card_memory_bytes()}) against {peak_real} measured "
            f"(max_memory_allocated above the step's start "
            f"{m['step_peak']}): {ratio:.4f} (band {DRYRUN_PEAK_BAND}); "
            f"{costs.launches} counted ops against {measured_ops}; K8 "
            f"{k8} counted (need {k8_need}); largest op_bytes "
            + ", ".join(f"{n} {v:.4e}" for n, v in costs.top_bytes(4)))
        if ms < DRYRUN_TIME_FLOOR * bound:
            bad.append(f"{what}: measured {ms} ms below "
                       f"{DRYRUN_TIME_FLOOR} x t_bound {bound} ms")
        if costs.static_bytes != m["static_real"]:
            bad.append(f"{what}: static_bytes {costs.static_bytes} != "
                       f"{m['static_real']}")
        if not DRYRUN_PEAK_BAND[0] <= ratio <= DRYRUN_PEAK_BAND[1]:
            bad.append(f"{what}: peak ratio {ratio} outside "
                       f"{DRYRUN_PEAK_BAND}")
        if k8 != k8_need:
            bad.append(f"{what}: {k8} K8 launches counted, want {k8_need}")
    if bad:
        raise AssertionError("dryrun: " + "; ".join(bad))


# the mesh phase: qwen3-1.7b's decode steps a cache under the one-rank
# mesh (eager, and replays of the decode graph), at the LM phase's shapes
MESH_STEPS = 8
# the expert shards' summed partials against the single device's moe_ffn,
# in bf16: each shard's partial and each sum of two rounded to bf16 (four
# units in the last place at a row's largest |value|)
MOE_SHARD_RTOL = 2.0 ** -5
# the cells of the arch-and-shape pairs the card runs, sized and counted
# per device on the reference's production meshes
MESH_CELLS = (("qwen3-1.7b", "decode_32k"), ("qwen3-1.7b", "train_4k"),
              ("zamba2-2.7b", "decode_32k"), ("dbrx-132b", "decode_32k"))
# the recurrent archs' cells through mesh_cell, at full width with their
# depth cut (zamba2 to its first two shared-attention groups) and rwkv6 at
# the serving phase's rwkv_chunk
MESH_RECURRENT = (("zamba2-2.7b", {"n_layers": 12}),
                  ("rwkv6-3b", {"n_layers": 8, "rwkv_chunk": 32}))


def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def mesh_decode(torch, params, cfg, prompts, pq, mesh, what: str) -> list:
    """Four caches prefilled alike, two of them under ``mesh``; MESH_STEPS
    decode steps fed the same tokens, eagerly without and with the mesh
    (in turns, each timed on the host clock, synchronised) and as replays
    of a decode graph captured without and with it. The prefill logits,
    every step's logits and every cache tensor under the mesh equal the
    meshless ones bit for bit. Returns the K8 launches of each step under
    the mesh, eager and graph."""
    from repro_torch.kernels import pq_decode_kernel as pqk
    from repro_torch.launch import sharding as shd
    from repro_torch.models import model as model_lib
    from repro_torch.models.decode_graph import DecodeGraph, cache_tensors
    b, s = prompts.shape

    def prefill(on_mesh):
        if not on_mesh:
            return model_lib.prefill(params, prompts, cfg, max_seq=LM_MAX_SEQ,
                                     pq_cache=fresh_pq(torch, pq))
        with shd.use_mesh(mesh):
            return model_lib.prefill(params, prompts, cfg, max_seq=LM_MAX_SEQ,
                                     pq_cache=fresh_pq(torch, pq))

    (lg, eager), (lg_m, eager_m), (_, graphed), (_, graphed_m) = (
        prefill(on) for on in (False, True, False, True))
    if not torch.equal(lg, lg_m):
        raise AssertionError(f"{what}: the prefill under the mesh differs")
    graph = DecodeGraph(params, graphed, cfg, b)
    graph_m = DecodeGraph(params, graphed_m, cfg, b)
    tok = torch.argmax(lg[:, :cfg.vocab], -1)
    t_plain, t_mesh, k8 = [], [], []
    for i in range(MESH_STEPS):
        pos = torch.full((b,), s + i, dtype=torch.int32, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want, _ = model_lib.decode_step(params, eager, tok, pos, cfg)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        n0 = pqk.launches
        with shd.use_mesh(mesh):
            got, _ = model_lib.decode_step(params, eager_m, tok, pos, cfg)
        torch.cuda.synchronize()
        t_plain.append((t1 - t0) * 1e3)
        t_mesh.append((time.perf_counter() - t1) * 1e3)
        n1 = pqk.launches
        replay = graph.step(tok, pos)
        n2 = pqk.launches
        with shd.use_mesh(mesh):
            replay_m = graph_m.step(tok, pos)
        k8.append((n1 - n0, pqk.launches - n2))
        for name, a, c in (("eager", got, want), ("graph", replay_m, replay),
                           ("graph vs eager", replay, want)):
            if not torch.equal(a, c):
                raise AssertionError(
                    f"{what}: {name} under the mesh differs at step {i}: max"
                    f" |difference| {float((a.float() - c.float()).abs().max())}")
        tok = torch.argmax(want[:, :cfg.vocab], -1)
    for a, c in zip(cache_tensors(eager_m) + cache_tensors(graphed_m),
                    cache_tensors(eager) + cache_tensors(graphed)):
        if not torch.equal(a, c):
            raise AssertionError(f"{what}: a cache under the mesh differs")
    log(f"{what}: prefill, {MESH_STEPS} decode steps eager and as graph "
        f"replays under the (1, 1) mesh == without it bit for bit (logits, "
        f"every cache tensor); eager step {float(np.median(t_plain[1:])):.3f}"
        f" ms without the mesh, {float(np.median(t_mesh[1:])):.3f} ms under "
        f"it (host clock, synchronised, in turns, median of steps 2-"
        f"{MESH_STEPS}); K8 launches a step under the mesh (eager, graph): "
        f"{k8}")
    del graph, graph_m, eager, eager_m, graphed, graphed_m
    return k8


def mesh_cells(torch, params, cfg, prompts, pq, mesh, what: str):
    """The prefill and MESH_STEPS eager decode steps of ``launch.dryrun.
    mesh_cell`` under ``mesh`` (parameters, cache and batch placed as
    DTensors by the reference's serving rules) against the meshless eager
    steps fed the same tokens: prefill logits, every step's logits and
    every cache tensor bit for bit, every leaf a DTensor. Returns (the K8
    launches of each step of the cell, the meshless cache after the
    steps)."""
    from repro_torch.kernels import pq_decode_kernel as pqk
    from repro_torch.launch import dryrun
    from repro_torch.launch import sharding as shd
    from repro_torch.models import model as model_lib
    b, s = prompts.shape
    rules = dryrun.cell_rules(cfg, "decode_32k", mesh)
    want, wcache = model_lib.prefill(params, prompts, cfg, max_seq=LM_MAX_SEQ,
                                     pq_cache=fresh_pq(torch, pq))
    t0 = time.perf_counter()
    cell = dryrun.mesh_cell(cfg, "prefill", mesh, rules, params,
                            tokens=prompts, cache=fresh_pq(torch, pq),
                            max_seq=LM_MAX_SEQ)
    t_place = time.perf_counter() - t0
    got, cache = cell.step()
    if not torch.equal(got.full_tensor(), want):
        raise AssertionError(f"{what}: the prefill cell differs")
    tok = torch.argmax(want[:, :cfg.vocab], -1)
    pos = torch.full((b,), s, dtype=torch.int32, device="cuda")
    dc = dryrun.mesh_cell(cfg, "decode", mesh, rules, params, tokens=tok,
                          cache=cache, position=pos)
    t_plain, t_cell, k8 = [], [], []
    for i in range(MESH_STEPS):
        pos = torch.full((b,), s + i, dtype=torch.int32, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want, wcache = model_lib.decode_step(params, wcache, tok, pos, cfg)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        pqk.launches = 0
        got, _ = dc.step(tok, pos)
        torch.cuda.synchronize()
        k8.append(pqk.launches)
        t_plain.append((t1 - t0) * 1e3)
        t_cell.append((time.perf_counter() - t1) * 1e3)
        got = got.full_tensor()
        if not torch.equal(got, want):
            raise AssertionError(
                f"{what}: decode step {i} of the cell differs: max "
                f"|difference| {float((got.float() - want.float()).abs().max())}")
        tok = torch.argmax(want[:, :cfg.vocab], -1)
    got = dryrun.cache_entries(dc.cache)
    if set(got) != set(dryrun.cache_entries(wcache)):
        raise AssertionError(f"{what}: the cell's cache has other tensors")
    for name, c in dryrun.cache_entries(wcache).items():
        a = got[name]
        if not shd.is_placed(a) or not torch.equal(a.full_tensor(), c):
            raise AssertionError(f"{what}: the cell's cache {name} differs")
    if not all(shd.is_placed(p) for p in dc.params.parameters()):
        raise AssertionError(f"{what}: a parameter left its placement")
    log(f"{what}: mesh_cell's prefill and {MESH_STEPS} eager decode steps "
        f"(parameters, cache and batch DTensors on the (1, 1) mesh, "
        f"placed in {t_place:.2f} s; cache at "
        f"{tuple(next(iter(got.values())).placements)}) == the meshless "
        f"steps bit for "
        f"bit (logits, every cache tensor); eager step "
        f"{float(np.median(t_plain[1:])):.3f} ms meshless, "
        f"{float(np.median(t_cell[1:])):.3f} ms through the cell (host "
        f"clock, synchronised, in turns, median of steps 2-{MESH_STEPS}); "
        f"K8 launches a step of the cell: {k8}")
    del cell, dc, cache
    return k8, wcache


def k8_sharded(torch, args, cache, cfg) -> None:
    """K8's sharded mode on qwen3-1.7b's PQ cache (layer 0's codes and
    codebooks, B LM_BATCH, Smax LM_MAX_SEQ, about 2,070 live positions a
    row, a random query) over 2 and 4 shards of the positions, in turn on
    the one card: each shard's split pass at its offset, the partials
    concatenated in shard order, the combine pass. Equal to the one-rank
    K8 bit for bit (the shards' lengths are multiples of its 256-position
    splits) and within K8_RTOL of ``pq_decode_plain(split=256)``; each
    pass timed by CUDA events, its bound at the local shapes; each run's
    launches on a ``mesh:`` line of its own."""
    from repro_torch.kernels import pq_decode_kernel as pqk
    b, h, hd = LM_BATCH, cfg.n_heads, cfg.resolved_head_dim
    kc, vc, kcb, vcb = (t[0] for t in cache)
    kv, m = kcb.shape[0], kcb.shape[1]
    gen = torch.Generator(device="cuda").manual_seed(args.seed + 90)
    q = torch.randn((b, h, hd), generator=gen, device="cuda").to(
        torch.bfloat16)
    positions = [2069 - 7 * r for r in range(b)]
    path = k8_glue(torch, q, kc, vc, kcb, vcb, positions, True)
    table, scale, bias, _, _, _, pos = path
    out = torch.bfloat16
    n0 = pqk.launches
    one = pqk.pq_decode(*path, chunk=2048, out_dtype=out)
    twin = pqk.pq_decode_plain(*path, chunk=2048, out_dtype=out,
                               split=pqk.SPLIT)
    pqk.launches = n0
    row = twin.float().abs().amax(-1, keepdim=True).clamp_min(1e-30)
    for n in (2, 4):
        sl = LM_MAX_SEQ // n
        shards = [(kc[:, r * sl:(r + 1) * sl].contiguous(),
                   vc[:, r * sl:(r + 1) * sl].contiguous()) for r in range(n)]

        def split(r):
            return pqk.pq_decode_split(table, scale, bias, *shards[r], vcb,
                                       pos, pos_offset=r * sl)

        pqk.launches = 0
        work = torch.cat([split(r) for r in range(n)], dim=3)
        got = pqk.pq_decode_combine(work, out_dtype=out)
        torch.cuda.synchronize()
        launched = pqk.launches
        if launched != n + 1:
            raise AssertionError(f"mesh: K8 sharded over {n}: {launched} "
                                 "launches")
        err = float(((got.float() - twin.float()).abs() / row).max())
        if not torch.equal(got, one) or err > K8_RTOL["bfloat16"]:
            raise AssertionError(
                f"mesh: K8 sharded over {n} shards != the one-rank K8 (max "
                f"|difference| {float((got.float() - one.float()).abs().max())}"
                f", against the split-order plain {err})")
        n1 = pqk.launches
        split_ms = [event_ms(torch, lambda r=r: split(r), 20)
                    for r in range(n)]
        comb_ms = event_ms(torch, lambda: pqk.pq_decode_combine(
            work, out_dtype=out), 20)
        pqk.launches = n1
        # each row's live positions in the shard, and its live splits
        costs = []
        for r in range(n):
            live = [max(0, min(sl, p + 1 - r * sl)) for p in positions]
            costs.append(kernel_bound(
                f"mesh: K8 split pass, shard {r} of {n}", "pq_decode_split",
                b=b, kv=kv, g=h // kv, m=m, head_dim=hd, live=live,
                nsplit=pqk.n_splits(sl), q8=True, cb_itemsize=2))
        cb = kernel_bound(f"mesh: K8 combine pass over {n} shards",
                          "pq_decode_combine", b=b, kv=kv, g=h // kv,
                          head_dim=hd, nsplit=work.shape[3],
                          live_splits=[pqk.n_splits(p + 1) for p in positions],
                          out_itemsize=2)
        log(f"mesh: K8 sharded mode over {n} shards of {sl} positions "
            f"(positions {positions[-1]}-{positions[0]}): == the one-rank K8 "
            f"bit for bit, {err:.3e} of the row's largest |value| from "
            f"pq_decode_plain(split=256) (tolerance {K8_RTOL['bfloat16']}); "
            f"{launched} launches ({n} split, 1 combine); split pass ms a "
            f"shard (events, 20 calls) "
            f"{[round(t, 6) for t in split_ms]} (bounds "
            f"{[round(c[2], 6) for c in costs]}), combine {comb_ms:.6f} ms "
            f"(bound {cb[2]:.6f}); the one-rank call's two passes "
            f"{event_ms(torch, lambda: pqk.pq_decode(*path, chunk=2048, out_dtype=out), 20):.6f} ms")
        pqk.launches = n1


def in_lockstep(torch, ranks) -> tuple[list, dict]:
    """Run generators of ``kvcache.subspace_rank``'s kind, the shards of one
    device, in lockstep, each collective done across the shards as the
    mesh's is: "max" their elementwise largest, "gather" their tensors
    concatenated along the last dim in shard order, "sum" their sum.
    Returns their results in shard order and each collective's result by
    its op."""
    reduce = {"max": lambda xs: torch.stack(xs).amax(0),
              "gather": lambda xs: torch.cat(xs, dim=-1),
              "sum": lambda xs: sum(xs[1:], xs[0])}
    seen, results = {}, [None] * len(ranks)
    asked = [next(r) for r in ranks]
    while asked:
        ops = {op for op, _ in asked}
        if len(ops) != 1 or len(asked) != len(ranks):
            raise AssertionError(f"the shards left lockstep: {ops}")
        op = ops.pop()
        seen[op] = got = reduce[op]([x for _, x in asked])
        asked = []
        for i, r in enumerate(ranks):
            try:
                asked.append(r.send(got))
            except StopIteration as done:
                results[i] = done.value
    return results, seen


def k8_subspaces(torch, args, cache, cfg) -> tuple[dict, dict]:
    """K8's sub-space mode on qwen3-1.7b's PQ cache (layer 0's codes and
    codebooks, B LM_BATCH, Smax LM_MAX_SEQ, about 2,070 live positions a
    row, a random query) over 2 and then 4 shards of its M = 64
    sub-spaces, in turn on the one card: each shard runs the port's own
    rank body (``kvcache.subspace_rank``: its head_dim slice of q and its
    sub-spaces' codes and codebooks, as views) and the shards run in
    lockstep, each collective done across them (``in_lockstep``). Held:
    the all-reduced i32 sums equal the plain sums of the one-rank table
    bit for bit, the scale from the MAX all-reduce and the summed
    gathered biases equal the one-rank quantizer's, so the scores are the
    one-rank K8's bit for bit; the concatenated slices within K8_RTOL of
    the one-rank K8. The launches of these runs (counted from 0) are the
    two passes' entries of the kernels line; each pass is then timed by
    CUDA events beside its plain version and its bound, with a ``cost:``
    line. Returns the two entries."""
    from repro_torch.kernels import pq_decode_kernel as pqk
    from repro_torch.models import kvcache as kvc
    b, h, hd = LM_BATCH, cfg.n_heads, cfg.resolved_head_dim
    kc, vc, kcb, vcb = (t[0] for t in cache)
    kv, m = kcb.shape[0], kcb.shape[1]
    g = h // kv
    gen = torch.Generator(device="cuda").manual_seed(args.seed + 93)
    q = torch.randn((b, h, hd), generator=gen, device="cuda").to(
        torch.bfloat16)
    positions = [2069 - 7 * r for r in range(b)]
    path = k8_glue(torch, q, kc, vc, kcb, vcb, positions, True)
    table, scale, bias, _, _, _, pos = path
    out = torch.bfloat16
    n0, by0 = pqk.launches, dict(pqk.launches_by)
    scores = torch.full((b, kv, g, LM_MAX_SEQ), float("-inf"), device="cuda")
    one = pqk.pq_decode(*path, chunk=2048, out_dtype=out, scores=scores)
    pqk.launches, pqk.launches_by = n0, by0
    live = (torch.arange(LM_MAX_SEQ, device="cuda")[None]
            <= pos[:, None].long())[:, None, None].expand_as(scores)
    want_sums = pqk.plain_scores(table, kc, pos)
    row = one.float().abs().amax(-1, keepdim=True).clamp_min(1e-30)
    name = ("pq_decode_scores", "pq_decode_values")
    for k in name:
        pqk.launches_by[k] = 0
    runs = {}
    for n in (2, 4):
        ml, dl = m // n, hd // n
        outs, seen = in_lockstep(torch, [kvc.subspace_rank(
            q[..., r * dl:(r + 1) * dl],
            kc[..., r * ml // 2:(r + 1) * ml // 2],
            vc[..., r * ml // 2:(r + 1) * ml // 2],
            kcb[:, r * ml:(r + 1) * ml], vcb[:, r * ml:(r + 1) * ml],
            pos, hd) for r in range(n)])
        got = torch.cat(outs, dim=-1)
        sums = seen["sum"]
        torch.cuda.synchronize()
        held = {
            "sums": torch.equal(sums, want_sums),
            "scale": torch.equal(torch.clamp_min(seen["max"], 1e-20)
                                 / 255.0, scale),
            "bias": torch.equal(seen["gather"].sum(-1), bias)}
        got_scores = scale[..., None] * sums.float() + bias[..., None]
        held["scores"] = torch.equal(got_scores[live], scores[live])
        err = float(((got.float() - one.float()).abs() / row).max())
        if not all(held.values()) or err > K8_RTOL["bfloat16"]:
            raise AssertionError(
                f"mesh: K8's sub-space mode over {n} shards: equal to the "
                f"one-rank K8's {held}, output {err} of the row's largest "
                f"|value| from the one-rank K8")
        runs[n] = (sums, err)
    launched = {k: pqk.launches_by[k] for k in name}
    if launched != {k: 2 + 4 for k in name}:
        raise AssertionError(f"mesh: K8's sub-space mode launched {launched}")
    # the passes against their plain versions and timed, at 4 shards (not
    # counted as launches of the path)
    n1, by1 = pqk.launches, dict(pqk.launches_by)
    sums, err4 = runs[4]
    ml = m // 4
    t4, k4, v4, cb4 = (table[..., :ml, :].contiguous(),
                       kc[..., :ml // 2].contiguous(),
                       vc[..., :ml // 2].contiguous(),
                       vcb[:, :ml].contiguous())
    plain_s = pqk.plain_scores(t4, k4, pos)
    got_s = pqk.pq_decode_scores(t4, k4, pos)
    plain_v = pqk.plain_values(sums, scale, bias, v4, cb4, pos)
    got_v = pqk.pq_decode_values(sums, scale, bias, v4, cb4, pos)
    torch.cuda.synchronize()
    s_err = float((got_s - plain_s).abs().max())
    # the partials' maxima m_j bit for bit; their sums l_j and value sums
    # (a dead split's are not written) through the combine pass in f32,
    # against the plain partials' within K8_RTOL["float32"] of each row's
    # largest |value|: both sums add in another order
    vo = pqk.pq_decode_combine(got_v, out_dtype=torch.float32)
    vw = pqk.pq_decode_combine(plain_v, out_dtype=torch.float32)
    v_err = float(((vo - vw).abs() / vw.abs().amax(-1, keepdim=True)
                   .clamp_min(1e-30)).max())
    if s_err != 0 or not torch.equal(got_v[..., 0], plain_v[..., 0]) \
            or v_err > K8_RTOL["float32"]:
        raise AssertionError(f"mesh: K8's sub-space passes against their "
                             f"plain versions: {s_err}, {v_err}")
    ms_s = event_ms(torch, lambda: pqk.pq_decode_scores(t4, k4, pos), 20)
    plain_ms_s = event_ms(torch, lambda: pqk.plain_scores(t4, k4, pos), 5)
    ms_v = event_ms(torch, lambda: pqk.pq_decode_values(
        sums, scale, bias, v4, cb4, pos), 20)
    plain_ms_v = event_ms(torch, lambda: pqk.plain_values(
        sums, scale, bias, v4, cb4, pos), 5)
    one_ms = event_ms(torch, lambda: pqk.pq_decode(*path, chunk=2048,
                                                   out_dtype=out), 20)
    pqk.launches, pqk.launches_by = n1, by1
    live_rows = [min(p + 1, LM_MAX_SEQ) for p in positions]
    _, _, bs, bys = kernel_bound(
        "mesh: K8 scoring pass, shard 0 of 4 sub-space shards",
        "pq_decode_scores", b=b, kv=kv, g=g, m=ml, smax=LM_MAX_SEQ,
        live=live_rows)
    _, _, bv, byv = kernel_bound(
        "mesh: K8 value pass, shard 0 of 4 sub-space shards",
        "pq_decode_values", b=b, kv=kv, g=g, m=ml, head_dim=hd // 4,
        live=live_rows, nsplit=pqk.n_splits(LM_MAX_SEQ), cb_itemsize=2)
    log(f"mesh: K8's sub-space mode over 2 and 4 shards of M {m} "
        f"(positions {positions[-1]}-{positions[0]}) through "
        f"kvcache.subspace_rank in lockstep: the all-reduced i32 sums == "
        f"the plain sums, the scale and summed bias the one-rank "
        f"quantizer's and the one-rank K8's scores bit for bit; the "
        f"concatenated slices {runs[2][1]:.3e} and {err4:.3e} of the row's "
        f"largest |value| from the one-rank K8 (tolerance "
        f"{K8_RTOL['bfloat16']}); launches {launched} (and "
        f"{2 + 4} combines); at 4 shards (M {ml}, head_dim {hd // 4}) the "
        f"scoring pass {ms_s:.6f} ms (plain {plain_ms_s:.5f}, bound "
        f"{bs:.6f} {bys}), the value pass {ms_v:.6f} ms (plain "
        f"{plain_ms_v:.5f}, bound {bv:.6f} {byv}), against their plain "
        f"versions: sums bit for bit, the splits' maxima bit for bit, the "
        f"combined partials {v_err:.3e} of the row's largest |value| "
        f"(tolerance "
        f"{K8_RTOL['float32']}); the one-rank "
        f"K8's two passes {one_ms:.6f} ms (events, 20 calls)")
    src = "src/repro_torch/kernels/csrc/pq_decode_attention.cu"
    return tuple(dict(name=k, route="cuda", source=src,
                      replaces="src/repro/models/kvcache.py:156",
                      launches=launched[k], max_abs_err=e, ms=t,
                      plain_ms=pt, bound_ms=bd, bound_by=bb,
                      library_ms=None)
                 for k, e, t, pt, bd, bb in (
                     (name[0], s_err, ms_s, plain_ms_s, bs, bys),
                     (name[1], v_err, ms_v, plain_ms_v, bv, byv)))


def mesh_count(torch, mesh) -> None:
    """qwen3-1.7b's exact and PQ decode cells and zamba2-2.7b's PQ one
    (its CONFIG's) at B LM_BATCH x LM_MAX_SEQ counted on the meta device
    over the one-rank NCCL mesh (``dryrun.count_mesh_cell``: DTensors on
    the card's ``DeviceMesh``) against the one-card count
    (``count_cell``): matmul FLOPs, compulsory bytes, peak of live bytes
    and K8 launches equal, no wire bytes, the FLOPs within the placed
    cache writes' index arithmetic (3 a layer)."""
    from repro_torch import configs
    from repro_torch.launch import dryrun
    for arch, pq in ((LM_ARCH, False), (LM_ARCH, True),
                     ("zamba2-2.7b", True)):
        cfg = configs.get_config(arch).replace(kv_pq=pq)
        t0 = time.perf_counter()
        got = dryrun.count_mesh_cell(cfg, "decode", LM_BATCH, LM_MAX_SEQ,
                                     mesh, dryrun.cell_rules(
                                         cfg, "decode_32k", mesh))
        t1 = time.perf_counter()
        want = dryrun.count_cell(cfg, "decode", LM_BATCH, LM_MAX_SEQ)
        what = f"mesh: count {arch} {'pq' if pq else 'exact'}"
        log(f"{what}: decode at B {LM_BATCH} x {LM_MAX_SEQ} over the (1, 1) "
            f"NCCL mesh in {t1 - t0:.2f} s: {got.flops:.0f} FLOPs "
            f"({got.matmul_flops:.0f} matmul), {got.min_bytes} compulsory B, "
            f"peak {got.peak_live_bytes} B, wire {got.wire_bytes} B, "
            f"kernels {got.kernels}; one card: {want.flops:.0f} "
            f"({want.matmul_flops:.0f}), {want.min_bytes}, peak "
            f"{want.peak_live_bytes}, kernels {want.kernels}")
        if (got.matmul_flops != want.matmul_flops
                or got.min_bytes != want.min_bytes
                or got.peak_live_bytes != want.peak_live_bytes
                or got.wire_bytes != 0 or got.kernels != want.kernels
                or not 0 <= got.flops - want.flops <= 3 * cfg.n_layers):
            raise AssertionError(f"{what}: the one-rank mesh count differs "
                                 "from the one-card count")


def mesh_recurrent(torch, args, mesh) -> None:
    """zamba2-2.7b and rwkv6-3b at full width, their depth cut to
    MESH_RECURRENT's (logged as reductions), through ``mesh_cell`` under
    the one-rank NCCL mesh (``mesh_cells``): the prefill and MESH_STEPS
    eager decode steps bit for bit the meshless ones (logits, every state
    and cache tensor), zamba2 with its exact shared-attention cache and
    with its PQ one (codebooks from ``serve.calibrate_hybrid_codebooks``
    on 2 x 256 prompt positions), K8 launched once a shared-attention
    group a PQ step, printed on a ``mesh:`` line."""
    from repro_torch.launch import serve
    from repro_torch.models import model as model_lib
    for arch, cut in MESH_RECURRENT:
        cfg, params, prompts = full_model(torch, args, arch, **cut)
        runs = [(cfg.replace(kv_pq=False), None)]
        if cfg.block_type == "mamba2":
            pq_cfg = cfg.replace(kv_pq=True)
            cache = model_lib.init_cache(pq_cfg, LM_BATCH, LM_MAX_SEQ)
            cache.update(serve.calibrate_hybrid_codebooks(
                torch.Generator().manual_seed(args.seed), params, cfg,
                prompts[:2, :256]))
            runs.append((pq_cfg, cache))
        for c, pq in runs:
            kind = ("pq " if pq else "exact ") if c.shared_attn_every else ""
            what = f"mesh: {arch} {kind}cell"
            k8, _ = mesh_cells(torch, params, c, prompts, pq, mesh, what)
            if pq is None:
                continue
            groups = c.n_layers // c.shared_attn_every
            log(f"mesh: K8 launches on {arch}'s PQ cell's {MESH_STEPS} "
                f"decode steps: {sum(k8)} ({k8}; {groups} shared-attention "
                f"groups a step)")
            if any(n != groups for n in k8):
                raise AssertionError(f"{what}: K8 launches a step {k8}, want "
                                     f"{groups} each")
        del params, prompts, runs
        gc.collect()
        torch.cuda.empty_cache()


# the train cells through mesh_cell: (arch, cut, batch, microbatches) at
# TRAIN_SEQ tokens a row; qwen3 whole at the training phase's shapes, the
# recurrent archs at full width with MESH_RECURRENT's depth
MESH_TRAIN = (("qwen3-1.7b", {}, TRAIN_BATCH, TRAIN_MICRO),
              *((arch, cut, TRAIN_REC_BATCH, 1) for arch, cut in MESH_RECURRENT))


def mesh_train(torch, args, mesh) -> None:
    """The train cells of MESH_TRAIN under the one-rank NCCL mesh and the
    training rules, under deterministic algorithms: each arch's meshless
    step (``make_train_step``) from its seeded state, then
    ``mesh_cell(..., "train")`` from the same parameters and batch with
    every parameter, moment and batch tensor a DTensor (the unplaced
    parameters dropped before the step): the loss, the grad norm and
    every parameter and moment after the step equal bit for bit, the
    mesh step's peak of allocated bytes printed. Then qwen3-1.7b's train
    cell at TRAIN_BATCH x TRAIN_SEQ counted over the one-rank mesh
    (``dryrun.count_mesh_cell``) against the one-card count: matmul
    FLOPs, compulsory and static bytes equal, no wire bytes."""
    from repro_torch import configs
    from repro_torch.data import tokens as tok_lib
    from repro_torch.launch import dryrun
    from repro_torch.launch import sharding as shd
    from repro_torch.models import model as model_lib
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import train_loop
    dev = torch.device("cuda", torch.cuda.current_device())
    ocfg = opt_lib.AdamWConfig(total_steps=1000)
    for arch, cut, batch_size, micro in MESH_TRAIN:
        cfg = configs.get_config(arch).replace(**cut)
        what = f"mesh: {arch} train cell"
        pipe = tok_lib.TokenPipelineConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                           global_batch=batch_size, seed=0)
        batch = dict(tok_lib.batch_at_step(pipe, 0, dev)._asdict())
        runs = []
        torch.use_deterministic_algorithms(True)
        try:
            state = train_loop.init_train_state(cfg, args.seed, dev)
            torch.cuda.synchronize()
            t = time.perf_counter()
            state, m = train_loop.make_train_step(cfg, ocfg, micro)(state,
                                                                   batch)
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t, m["loss"].item(),
                         m["grad_norm"].item(), host_bits(torch, state)))
            del state, m
            gc.collect()
            torch.cuda.empty_cache()
            params = model_lib.init_lm(cfg, generator=torch.Generator(
                device=dev).manual_seed(args.seed), device=dev)
            cell = dryrun.mesh_cell(cfg, "train", mesh, dryrun.cell_rules(
                cfg, "train_4k", mesh), params, microbatches=micro, **batch)
            del params
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t = time.perf_counter()
            state, m = cell.step()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            runs.append((time.perf_counter() - t,
                         m["loss"].full_tensor().item(),
                         m["grad_norm"].full_tensor().item(),
                         host_bits(torch, state)))
            placed = all(shd.is_placed(t) for t in (
                *state.params.parameters(), *state.opt.mu.values(),
                *state.opt.nu.values(), state.opt.step))
            del state, m, cell
            gc.collect()
            torch.cuda.empty_cache()
        finally:
            torch.use_deterministic_algorithms(False)
        (s0, l0, g0, b0), (s1, l1, g1, b1) = runs
        differ = sorted(k for k in b0 if not torch.equal(b0[k], b1.get(k)))
        log(f"{what}: {batch_size} x {TRAIN_SEQ} in {micro} microbatches, "
            f"{cfg.n_layers} layers (reduced: "
            + (", ".join(f"{k} {getattr(configs.get_config(arch), k)} -> {v}"
                         for k, v in cut.items()) or "nothing")
            + f"): loss {l0:.6f} / {l1:.6f}, grad norm {g0:.6f} / {g1:.6f} "
            f"meshless / through the cell; {len(b0) - len(differ)} of "
            f"{len(b0)} tensors (params, mu, nu, step) equal bit for bit; "
            f"every one a DTensor: {placed}; step {s0 * 1e3:.1f} / "
            f"{s1 * 1e3:.1f} ms; the cell's peak {peak} B allocated")
        if differ or set(b0) != set(b1) or l0 != l1 or g0 != g1 \
                or not placed:
            raise AssertionError(f"{what}: differs from the meshless step: "
                                 f"{differ[:5]}")
        del runs, b0, b1, batch
    cfg = configs.get_config(TRAIN_ARCH)
    t0 = time.perf_counter()
    got = dryrun.count_mesh_cell(cfg, "train", TRAIN_BATCH, TRAIN_SEQ, mesh,
                                 dryrun.cell_rules(cfg, "train_4k", mesh))
    t1 = time.perf_counter()
    want = dryrun.count_cell(cfg, "train", TRAIN_BATCH, TRAIN_SEQ)
    what = f"mesh: count {TRAIN_ARCH} train"
    log(f"{what}: at B {TRAIN_BATCH} x {TRAIN_SEQ} over the (1, 1) NCCL mesh "
        f"in {t1 - t0:.2f} s: {got.flops:.0f} FLOPs ({got.matmul_flops:.0f} "
        f"matmul), {got.min_bytes} compulsory B, static {got.static_bytes} "
        f"B, peak {got.peak_live_bytes} B, wire {got.wire_bytes} B; one "
        f"card: {want.flops:.0f} ({want.matmul_flops:.0f}), {want.min_bytes},"
        f" static {want.static_bytes}, peak {want.peak_live_bytes}")
    if (got.matmul_flops != want.matmul_flops
            or got.min_bytes != want.min_bytes
            or got.static_bytes != want.static_bytes or got.wire_bytes != 0):
        raise AssertionError(f"{what}: the one-rank mesh count differs from "
                             "the one-card count")


def moe_shards(torch, args) -> None:
    """dbrx-132b's expert-parallel bodies at full width (one layer's MoE,
    the MoE phase's B 8 x 2,048 prompt tokens), over 2 and 4 expert
    shards in turn on the one card: each shard routes the same gates
    (its maps equal the single device's bit for bit), fills its experts'
    slots (``moe.dispatch_shard``), runs its experts and takes its partial
    (``moe.combine_shard``); the partials summed in shard order are held
    within MOE_SHARD_RTOL of each row's largest |value| of the single
    device's ``moe_ffn``."""
    from types import SimpleNamespace

    from repro_torch import configs
    from repro_torch.models import layers as ll
    from repro_torch.models import moe
    cfg = configs.get_config("dbrx-132b")
    specs = moe.moe_specs(cfg)
    p = ll.Params(specs, dtype=torch.bfloat16, device=torch.device("cuda"))
    ll.init_params(p, specs, torch.Generator(device="cuda").manual_seed(
        args.seed + 91))
    gen = torch.Generator(device="cuda").manual_seed(args.seed + 92)
    b, s, d = LM_BATCH, LM_PROMPT, cfg.d_model
    x = torch.randn((b, s, d), generator=gen, device="cuda").to(torch.bfloat16)
    maps = []
    real = moe.route

    def route(gates, c):
        maps.append(real(gates, c))
        return maps[-1]

    moe.route = route
    try:
        want, _ = moe.moe_ffn(p, x, cfg)
    finally:
        moe.route = real
    want = want.reshape(-1, d)
    single = maps[0]
    g = moe._num_groups(cfg, b * s)
    xg = x.reshape(g, -1, d)
    gates = torch.softmax((xg @ p.router).float(), dim=-1)
    e = cfg.n_experts
    row = want.float().abs().amax(-1, keepdim=True).clamp_min(1e-30)
    for n in (2, 4):
        e_l = e // n
        total = None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for k in range(n):
            r = moe.route(gates, cfg)
            for name in r._fields:
                if not torch.equal(getattr(r, name), getattr(single, name)):
                    raise AssertionError(f"mesh: dbrx shard {k} of {n}: the "
                                         f"map {name} differs")
            lo = k * e_l
            buf = moe.dispatch_shard(xg, r.tok_for_slot[:, lo:lo + e_l],
                                     r.slot_valid[:, lo:lo + e_l])
            ps = SimpleNamespace(**{w: getattr(p, w)[lo:lo + e_l]
                                    for w in ("wi_gate", "wi_up", "wo")})
            yb = moe._expert_ffn(ps, buf, cfg)
            part = moe.combine_shard(yb, r.es_tok, r.ps_tok, r.keep_tok,
                                     r.gate_k, lo, x.dtype)
            total = part if total is None else total + part
            del buf, yb, part
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        err = float(((total.reshape(-1, d).float() - want.float()).abs()
                     / row).max())
        log(f"mesh: dbrx-132b expert parallelism over {n} shards of {e_l} "
            f"experts (one layer, {b} x {s} tokens, {g} groups): the maps "
            f"== the single device's bit for bit on every shard; the "
            f"partials' sum {err:.3e} of each row's largest |value| from "
            f"the single device's moe_ffn (tolerance {MOE_SHARD_RTOL}); "
            f"{ms:.1f} ms for the shards in turn (host clock)")
        if err > MOE_SHARD_RTOL:
            raise AssertionError(f"mesh: dbrx over {n} expert shards: "
                                 f"{err} > {MOE_SHARD_RTOL}")
    del p, x, want, xg, gates, total
    gc.collect()
    torch.cuda.empty_cache()


def mesh_phase(torch, args) -> tuple[dict, dict]:
    """The LM under a one-rank device mesh (``launch/mesh.py``,
    ``launch/sharding.py``): a one-rank NCCL process group on a free local
    port and ``make_host_mesh()``'s (1, 1) ``DeviceMesh`` on the card;
    under ``use_mesh`` qwen3-1.7b's exact and PQ decode (``mesh_decode``),
    equal to the meshless run bit for bit, 28 K8 launches a PQ step; the
    train cells through ``mesh_cell`` with every parameter, moment and
    batch tensor a DTensor (``mesh_train``: qwen3-1.7b whole at the
    training phase's shapes, zamba2 and rwkv6 at MESH_RECURRENT's depth),
    bit for bit the meshless steps, and qwen3's train cell counted over
    the one-rank mesh against the one-card count; a DTensor
    through ``constrain``; the serving cells through ``mesh_cell`` with
    every tensor a DTensor (``mesh_cells``), bit for bit, 28 K8 launches
    a PQ step; K8's sharded mode over 2 and 4 shards of the PQ cache
    (``k8_sharded``) and its sub-space mode over 2 and 4 shards of the
    sub-spaces (``k8_subspaces``, whose two passes' entries of the kernels
    line it returns); qwen3-1.7b's decode counted over the one-rank NCCL
    mesh against the one-card count (``mesh_count``); MESH_CELLS sized
    and counted per device on the reference's pod and multipod meshes;
    dbrx-132b's expert-parallel
    bodies over 2 and 4 shards (``moe_shards``). The card machine has one
    H100: a mesh of several ranks runs as gloo ranks on the CPU (the
    tests), and here the shards run in turn. The group is destroyed
    before the phase returns. K8's launches on the mesh cell's PQ path
    and in the sharded runs are printed on ``mesh:`` lines of their own,
    apart from the kernels line's."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch import configs
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import serve
    from repro_torch.launch import sharding as shd
    from repro_torch.models import model as model_lib
    gc.collect()
    torch.cuda.empty_cache()
    dev = torch.device("cuda", torch.cuda.current_device())
    port = free_port()
    t0 = time.perf_counter()
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1, device_id=dev)
    try:
        mesh = mesh_lib.make_host_mesh()
        log(f"mesh: a one-rank NCCL group on 127.0.0.1:{port} and {mesh} "
            f"({mesh.device_mesh}) in {time.perf_counter() - t0:.2f} s")
        x = torch.randn((LM_BATCH, 2048), generator=torch.Generator(
            device="cuda").manual_seed(args.seed + 60), device=dev)
        full = distribute_tensor(x, mesh.device_mesh,
                                 [Replicate(), Replicate()])
        with shd.use_mesh(mesh):
            y = shd.constrain(full, "batch", "embed")
        if y.placements != (Shard(0), Replicate()) or \
                not torch.equal(y.to_local(), x):
            raise AssertionError(f"mesh: constrain gave {y.placements}")
        log(f"mesh: a replicated DTensor through constrain('batch', "
            f"'embed'): placements {y.placements}, its shard the tensor")

        cfg = configs.get_config(LM_ARCH)
        exact_cfg, pq_cfg = cfg.replace(kv_pq=False), cfg.replace(kv_pq=True)
        params = model_lib.init_lm(cfg, generator=torch.Generator(
            device="cuda").manual_seed(args.seed), device=dev)
        rng = np.random.default_rng(args.seed + 24)
        prompts = torch.as_tensor(rng.integers(
            0, cfg.vocab, (LM_BATCH, LM_PROMPT), dtype=np.int32), device=dev)
        pqc = serve.calibrate_pq_cache(torch.Generator().manual_seed(
            args.seed), params, pq_cfg, LM_BATCH, LM_MAX_SEQ)
        mesh_decode(torch, params, exact_cfg, prompts, None, mesh,
                    "mesh: exact")
        k8 = mesh_decode(torch, params, pq_cfg, prompts, pqc, mesh,
                         "mesh: pq")
        if any(e != cfg.n_layers or g < cfg.n_layers for e, g in k8):
            raise AssertionError(f"mesh: K8 launches a PQ step {k8}, want "
                                 f"{cfg.n_layers} each")
        mesh_cells(torch, params, exact_cfg, prompts, None, mesh,
                   "mesh: exact cell")
        k8, pq_cache = mesh_cells(torch, params, pq_cfg, prompts, pqc, mesh,
                                  "mesh: pq cell")
        if any(n != cfg.n_layers for n in k8):
            raise AssertionError(f"mesh: K8 launches a step of the PQ cell "
                                 f"{k8}, want {cfg.n_layers} each")
        log(f"mesh: K8 launches on the PQ cell's {MESH_STEPS} decode "
            f"steps: {sum(k8)} ({cfg.n_layers} a step)")
        k8_sharded(torch, args, pq_cache, cfg)
        subspace = k8_subspaces(torch, args, pq_cache, cfg)
        mesh_count(torch, mesh)
        del params, pqc, prompts, pq_cache
        gc.collect()
        torch.cuda.empty_cache()
        mesh_recurrent(torch, args, mesh)

        mesh_train(torch, args, mesh)
    finally:
        dist.destroy_process_group()
    log(f"mesh: the process group destroyed; initialised "
        f"{dist.is_initialized()}")
    for arch, shape in MESH_CELLS:
        for name in dryrun.POD_MESHES:
            r = dryrun.run_cell(arch, shape, mesh=name, verbose=False)
            pd = r["per_device"]
            log(f"mesh: {arch} {shape} on {name} ({r['chips']} devices, the "
                f"reference's rules): per device params {pd['param_bytes']},"
                f" opt {pd['opt_bytes']}, cache {pd['cache_bytes']}, batch "
                f"{pd['batch_bytes']} B; static {pd['static_bytes']} B "
                f"(fits {pd['fits']}), replicated {pd['replicated_bytes']} B "
                f"in {pd['replicated_leaves']} leaves; rules {pd['rules']}")
            roof = r["roofline"]
            bound = max(roof["t_compute_s"], roof["t_memory_s"],
                        roof["t_collective_s"])
            log(f"mesh: {arch} {shape} on {name} counted per device (a "
                f"fake group of {r['chips']} ranks on meta): "
                f"{r['flops']:.6e} FLOPs, {r['min_bytes']} compulsory B, "
                f"collectives {r['collectives']['ops']}, "
                f"{r['collectives']['wire_bytes_per_dev']:.0f} wire B; "
                f"bound {bound * 1e3:.6f} ms ({roof['bottleneck']}), MFU "
                f"bound {roof['mfu_bound']:.4f} at {rl.LINK_BW:.3e} B/s a "
                f"link; [{r['trace_s']} s]")
    moe_shards(torch, args)
    return subspace


def examples_phase(root: str) -> None:
    """The two ANN examples once on the card, each in its own process at
    its defaults (``--shards 4`` for the engine's): select equal to mxu
    and fast-scan within FIG2_GAP of naive PQ at recall@10, the re-rank
    above fast-scan alone."""
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    recalls = {}
    for script, extra in (("quickstart_torch.py", []),
                          ("ann_search_torch.py", ["--shards", "4"])):
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable,
                              os.path.join(root, "examples", script),
                              *extra], capture_output=True, text=True,
                             env=env, timeout=600)
        name = script.split("_torch")[0]
        for line in res.stdout.strip().splitlines():
            log(f"examples: {name}: {line}")
            if "recall@1=" in line:
                head = line.split(":")[0].strip()
                recalls[head] = {at: float(line.split(f"recall@{at}=")[1]
                                           .split()[0].rstrip(","))
                                 for at in ("1", "10")
                                 if f"recall@{at}=" in line}
        log(f"examples: {name}: exit {res.returncode} "
            f"[{time.perf_counter() - t0:.1f} s]")
        if res.returncode != 0:
            raise AssertionError(f"examples: {script} failed:\n"
                                 + res.stderr[-3000:])
    mxu, sel = recalls["fast-scan[mxu]"], recalls["fast-scan[select]"]
    naive = recalls["naive PQ (float LUT)"]
    if not (mxu == sel and abs(mxu["10"] - naive["10"]) < FIG2_GAP
            and recalls["+ exact re-rank"]["1"]
            > recalls["fast-scan only"]["1"]):
        raise AssertionError(f"examples: recalls out of line: {recalls}")


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
    # the training phase's resume check runs under deterministic
    # algorithms, which need this set before the process's first cuBLAS
    # call (the workspace size is the card's default)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
    # the LM phases take the card's memory: the ANN data and engine go
    del ds, engine
    gc.collect()
    torch.cuda.empty_cache()
    # 12. LM serving: qwen3-1.7b at full width, exact and PQ caches (K8)
    log(f"lm: phase starts {time.perf_counter() - t_main:.1f} s into the run")
    t0 = time.perf_counter()
    k8 = lm_phase(torch, args)
    log(f"lm: phase {time.perf_counter() - t0:.1f} s; the run so far "
        f"{time.perf_counter() - t_main:.1f} s")
    # 13. the recurrent families: zamba2-2.7b (its PQ shared-attention
    # cache through K8) and rwkv6-3b, at full width and depth
    t0 = time.perf_counter()
    zamba2_phase(torch, args)
    log(f"zamba2: phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    rwkv6_phase(torch, args)
    log(f"rwkv6: phase {time.perf_counter() - t0:.1f} s; the run so far "
        f"{time.perf_counter() - t_main:.1f} s")
    # 14. the frontend stubs whole (internvl2-1b, musicgen-medium), then
    # the MoE archs at full width with their depth cut (dbrx-132b,
    # llama4-scout-17b-a16e): exact and PQ caches, K8 at their shapes
    t0 = time.perf_counter()
    k8_paths = frontend_phase(torch, args)
    k8_paths += moe_phase(torch, args)
    log(f"frontend and moe: phases {time.perf_counter() - t0:.1f} s; the run "
        f"so far {time.perf_counter() - t_main:.1f} s")
    for p in k8_paths:
        log(f"K8 on the {p['path']} path ({p['shape']}): {p['launches']} "
            f"launches, {p['ms']:.6f} ms, plain {p['plain_ms']:.5f} ms, "
            f"bound {p['bound_ms']:.6f} ms ({p['bound_by']}), max error "
            f"{p['max_abs_err']:.3e}")
    # 15. LM training: qwen3-1.7b whole (8 steps, the codec, a checkpoint
    # and a resume bit for bit), one step each of zamba2-2.7b and rwkv6-3b
    t0 = time.perf_counter()
    train_phase(torch, args, root)
    log(f"train: phase {time.perf_counter() - t0:.1f} s; the run so far "
        f"{time.perf_counter() - t_main:.1f} s")
    # 15b. the dry-run's count of the paths just measured (meta device)
    t0 = time.perf_counter()
    dryrun_phase(torch)
    log(f"dryrun: phase {time.perf_counter() - t0:.1f} s; the run so far "
        f"{time.perf_counter() - t_main:.1f} s")
    # 15c. the LM under a one-rank device mesh, bit for bit
    t0 = time.perf_counter()
    k8s, k8v = mesh_phase(torch, args)
    log(f"mesh: phase {time.perf_counter() - t0:.1f} s; the run so far "
        f"{time.perf_counter() - t_main:.1f} s")
    # 16. the two ANN examples, each once in its own process
    t0 = time.perf_counter()
    examples_phase(root)
    log(f"examples: phase {time.perf_counter() - t0:.1f} s; the run so far "
        f"{time.perf_counter() - t_main:.1f} s")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = (k1, k2, k3, k4, k5, k6, k7a, k7b, k7c, k8, k8s, k8v)
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

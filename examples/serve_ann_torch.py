"""Serve ANN queries through the port's micro-batching loop on the card, end
to end (the counterpart of ``examples/serve_ann.py``):

build an IVF + 4-bit-PQ engine with ``repro_torch`` (the stream scan and
re-rank kernels, one CUDA graph a shape bucket), start
``repro_torch.serving.ServingLoop``, fire a ragged multi-tenant request
stream at it, and print per-tenant accounting and loop metrics. With
``--snapshot-dir`` the loop boots durable (an initial snapshot and a WAL
that fsyncs every write before it is visible), takes a few writes, and the
directory is reopened with ``persist.open_engine`` at the end.

    PYTHONPATH=src python examples/serve_ann_torch.py [--n 50000] \
        [--requests 200] [--snapshot-dir DIR] [--device cuda]

Imports neither jax nor the JAX package.
"""
import argparse
import asyncio
import math
import time

import numpy as np
import torch

from repro_torch import persist
from repro_torch.core import metrics
from repro_torch.data import vectors
from repro_torch.engine import EngineConfig, SearchEngine
from repro_torch.serving import ServingLoop


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=50_000)
    ap.add_argument("--requests", type=int, default=200)
    ap.add_argument("--rerank-mult", type=int, default=4)
    ap.add_argument("--max-wait-ms", type=float, default=2.0,
                    help="batching window: how long a request waits for "
                    "co-riders")
    ap.add_argument("--snapshot-dir", default=None,
                    help="boot durable into this (fresh) directory")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    print("== build engine ==")
    ds = vectors.make_sift_like(n=args.n, nt=max(5_000, args.n // 10),
                                nq=256, device=args.device)
    engine = SearchEngine.build(
        ds.train, ds.base, m=8, nlist=int(math.sqrt(args.n)),
        coarse_iters=10, pq_iters=10, device=args.device,
        config=EngineConfig(scan_impl="stream", rerank_impl="stream"))

    loop = ServingLoop(engine, rerank_mult=args.rerank_mult,
                       max_wait_s=args.max_wait_ms / 1e3,
                       snapshot_dir=args.snapshot_dir)
    loop.start(warmup=True)  # one graph capture per shape bucket
    warm = loop.metrics().compiles
    print(f"warmed up: {warm} graph captures (one per shape bucket "
          f"{loop.batcher.buckets} on the card, none on the CPU)")

    print(f"\n== serve {args.requests} requests from 3 tenants ==")
    rng = np.random.default_rng(0)
    queries = ds.queries.cpu().numpy()
    t0 = time.monotonic()
    futs, rows = [], []
    for i in range(args.requests):
        qi = i % queries.shape[0]
        tenant = ("alice", "bob", "carol")[i % 3]
        futs.append(loop.submit(queries[qi], k=10, tenant=tenant))
        rows.append(qi)
        if rng.random() < 0.3:               # ragged arrivals: bursty stream
            time.sleep(float(rng.exponential(0.002)))
    results = [f.result(timeout=60) for f in futs]
    wall = time.monotonic() - t0

    got = torch.from_numpy(np.stack([r.ids for r in results]))
    gt = ds.gt_ids.cpu()[torch.as_tensor(rows)]
    r1 = float(metrics.recall_at_r(got, gt, r=1))
    m = loop.metrics()
    print(f"{args.requests} requests in {wall:.2f}s "
          f"({args.requests / wall:.0f} qps), recall@1={r1:.3f}")
    print(f"batches={m.batches}, occupancy={m.occupancy:.2f}, "
          f"buckets={m.bucket_counts}, captures after warmup="
          f"{m.compiles - warm}")

    print("\n== per-tenant accounting ==")
    for tenant, st in sorted(loop.stats.snapshot().items()):
        print(f"  {tenant:8s} queries={st.queries:4d} "
              f"codes_scanned={st.codes_scanned:8d} "
              f"reranked={st.reranked:6d} "
              f"mean_latency={st.mean_latency_s * 1e3:6.2f}ms "
              f"max={st.latency_max_s * 1e3:6.2f}ms")

    print("\n== asyncio entry point ==")

    async def one():
        res = await loop.asearch(queries[0], k=5, tenant="async")
        return res.ids

    print("await loop.asearch(...) ->", asyncio.run(one()))

    if args.snapshot_dir is not None:
        print("\n== durable writes ==")
        new = rng.normal(size=(100, queries.shape[1])).astype(np.float32)
        loop.upsert(np.arange(args.n, args.n + 100), np.abs(new) * 64)
        loop.delete(np.arange(0, 100))
        loop.checkpoint()
        loop.close()
        t0 = time.monotonic()
        rec, info = persist.open_engine(args.snapshot_dir, attach=False,
                                        device=args.device)
        same = torch.equal(rec.search(queries[:32], 10).ids,
                           engine.search(queries[:32], 10).ids)
        print(f"reopened {info.snapshot} (wal_seq {info.wal_seq}, replayed "
              f"{info.replayed}) in {time.monotonic() - t0:.2f}s; same "
              f"results as the live engine: {same}")
    else:
        loop.stop()


if __name__ == "__main__":
    main()

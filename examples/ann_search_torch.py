"""End-to-end large-scale ANN pipeline (the paper's Table 1, scaled) through
the port's engine: HNSW coarse -> 4-bit fast-scan ADC -> exact re-rank ->
top-k (the counterpart of ``examples/ann_search.py``).

    PYTHONPATH=src python examples/ann_search_torch.py [--n 200000] \\
        [--nprobe 4] [--shards 4]                     # the card
    PYTHONPATH=src python examples/ann_search_torch.py --device cpu --n 20000

Builds ``SearchEngine`` with HNSW coarse over nlist = sqrt(N) lists on a
Deep1B-like base, searches with fast-scan only and with the exact re-rank,
then with the flat coarse quantizer over the same index (the exact probe
selection), and with ``--shards S`` through ``ShardedEngine``. The engine
keeps its defaults, as the reference's example does. On the CPU the scan
and re-rank run their plain versions. Imports neither jax nor the JAX
package.
"""
import argparse
import math
import time

import torch

from repro_torch.core import metrics
from repro_torch.data import vectors
from repro_torch.device import resolve_device
from repro_torch.engine import SearchEngine, ShardedEngine


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--m", type=int, default=16)
    ap.add_argument("--nprobe", type=int, default=4)
    ap.add_argument("--queries", type=int, default=128)
    ap.add_argument("--rerank-mult", type=int, default=4,
                    help="refine rerank_mult*k candidates exactly (0 = off)")
    ap.add_argument("--shards", type=int, default=0,
                    help="also run the shard-parallel path with S shards")
    ap.add_argument("--device", default=None,
                    help="cpu, or the CUDA card when omitted")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    print(f"== unified engine on {dev}: IVF + HNSW + 4-bit PQ + exact "
          "re-rank ==")
    ds = vectors.make_deep_like(n=args.n, nt=max(10_000, args.n // 10),
                                nq=args.queries, device=dev)
    nlist = int(math.sqrt(args.n))  # the paper's sqrt(N) heuristic
    print(f"N={args.n}, nlist={nlist}, M={args.m}, K=16, "
          f"nprobe={args.nprobe}")

    t0 = time.time()
    engine = SearchEngine.build(ds.train, ds.base, m=args.m, nlist=nlist,
                                coarse="hnsw", device=dev)
    sync()
    print(f"build: {time.time() - t0:.1f}s "
          f"(codes {tuple(engine.index.lists.codes.shape)}, "
          f"{4 * args.m} bits/vector)")

    def timed_search(rr):
        engine.search(ds.queries, 10, nprobe=args.nprobe, rerank_mult=rr)
        sync()      # warm-up at the same batch shape as timed
        t0 = time.time()
        res = engine.search(ds.queries, 10, nprobe=args.nprobe,
                            rerank_mult=rr)
        sync()
        return res, time.time() - t0

    res, dt = timed_search(0)
    r1 = float(metrics.recall_at_r(res.ids, ds.gt_ids, r=1))
    print(f"fast-scan only:   recall@1={r1:.3f}, "
          f"{dt / args.queries * 1e3:.3f} ms/query (scanned "
          f"~{float(res.stats.codes_scanned.float().mean()):.0f} codes/query)")

    if args.rerank_mult:
        res_rr, dt_rr = timed_search(args.rerank_mult)
        r1_rr = float(metrics.recall_at_r(res_rr.ids, ds.gt_ids, r=1))
        print(f"+ exact re-rank:  recall@1={r1_rr:.3f}, "
              f"{dt_rr / args.queries * 1e3:.3f} ms/query (re-ranked "
              f"{float(res_rr.stats.reranked.float().mean()):.0f}/query)")

    # the flat coarse quantizer over the same index (exact probe selection)
    flat = SearchEngine(engine.index, base=ds.base, coarse="flat")
    res_flat = flat.search(ds.queries, 10, nprobe=args.nprobe, rerank_mult=0)
    r1f = float(metrics.recall_at_r(res_flat.ids, ds.gt_ids, r=1))
    print(f"flat-coarse reference: recall@1={r1f:.3f} "
          f"(HNSW coarse loses {max(0.0, r1f - r1):.3f})")

    if args.shards > 1:
        sh = ShardedEngine(engine, args.shards)
        res_s = sh.search(ds.queries, 10, nprobe=args.nprobe,
                          rerank_mult=args.rerank_mult)
        r1s = float(metrics.recall_at_r(res_s.ids, ds.gt_ids, r=1))
        print(f"sharded x{args.shards} (flat coarse per shard): "
              f"recall@1={r1s:.3f} (probed "
              f"{int(res_s.stats.lists_probed[0])} lists/query total)")


if __name__ == "__main__":
    main()

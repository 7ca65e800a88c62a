"""Quickstart on the PyTorch/CUDA port: build a 4-bit fast-scan PQ index
and search it (the counterpart of ``examples/quickstart.py``).

    PYTHONPATH=src python examples/quickstart_torch.py              # the card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu

Builds the flat fast-scan index (``core.fastscan.build_index``, M = 16, K =
16) on 50,000 SIFT-like rows, searches it with ``impl='mxu'`` (the one-hot
scan, K7b on the card) and ``impl='select'`` (the look-up scan, K7a), then
with naive PQ (float LUT, ``core.pq.search``) beside them, and prints
recall@1 and @10: the paper's Fig. 2 pair. On the CPU each scan runs its
plain version. Imports neither jax nor the JAX package.
"""
import argparse
import time

import torch

from repro_torch.core import fastscan, metrics, pq
from repro_torch.data import vectors
from repro_torch.device import resolve_device


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=50_000)
    ap.add_argument("--device", default=None,
                    help="cpu, or the CUDA card when omitted")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    print(f"== 4-bit PQ fast-scan quickstart on {dev} ==")
    ds = vectors.make_sift_like(n=args.n, nt=10_000, nq=128, device=dev)
    print(f"dataset: base={tuple(ds.base.shape)} "
          f"queries={tuple(ds.queries.shape)}")

    # build: PQ codebooks (K=16 -> 4-bit codes), nibble-packed layout
    t0 = time.time()
    index = fastscan.build_index(ds.train, ds.base, m=16, iters=15,
                                 device=dev)
    sync()
    print(f"built index in {time.time() - t0:.1f}s: codes "
          f"{tuple(index.packed_codes.shape)} uint8 "
          f"({index.packed_codes.numel() / ds.base.numel() / 4 * 100:.1f}% "
          "of raw)")

    # the two scan formulations, then the naive-PQ baseline
    for impl in ("mxu", "select"):
        t0 = time.time()
        _, ids = fastscan.search(index, ds.queries, topk=10, impl=impl)
        sync()
        r1 = float(metrics.recall_at_r(ids, ds.gt_ids, r=1))
        r10 = float(metrics.recall_at_r(ids, ds.gt_ids, r=10))
        print(f"fast-scan[{impl}]: recall@1={r1:.3f} recall@10={r10:.3f} "
              f"({time.time() - t0:.2f}s incl. the first call)")

    codes = pq.encode(index.codebook, ds.base)
    t0 = time.time()
    _, ids = pq.search(index.codebook, codes, ds.queries, topk=10)
    sync()
    r1 = float(metrics.recall_at_r(ids, ds.gt_ids, r=1))
    r10 = float(metrics.recall_at_r(ids, ds.gt_ids, r=10))
    print(f"naive PQ (float LUT): recall@1={r1:.3f} recall@10={r10:.3f} "
          f"({time.time() - t0:.2f}s)  <- same accuracy, slower scan (the "
          "paper's Fig. 2 claim)")


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""The scan autotune verdicts of the port's anytime path and its device
busy time at each serving bucket, for the ``repro_torch`` package under
``--src``. Run on two trees in one call, in turns (old, new, new, old), it
shows how a kernel change moves the verdicts and the batches:

    python3 tools/anytime_verdicts.py --src src --pin build/pin.json \\
        [--label new] [--seed 0] [--n 1000000] [--nlist 1024]

Builds ``chip_smoke.py``'s index (a SIFT1M-shaped base from ``--seed``,
IVF nlist 1024, M = 16, cap a multiple of 1024) and serves it with the
anytime configuration (nprobe 32, margin 0.4, early exit, ``auto`` scan
and re-rank) at Q in {1, 8, 32, 128}, i.e. G = 32, 256, 1024 and 4096
groups. First with fresh sweeps: every verdict with its candidates'
times, then each bucket's device busy time (the sum of device-op times of
one profiled batch, median of three) and its largest device ops. Then
under the verdicts saved in ``--pin`` (a v3 autotune file; written from
this run's fresh verdicts when it does not exist yet), so that two trees
are compared under the same verdicts. Prints the card's name and power
limit first, one JSON line a verdict and a bucket. Needs a CUDA card;
imports neither jax nor the JAX package.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROFILED = 3          # profiled batches a bucket (median busy)
TIMED = 5             # host-timed batches a bucket (median latency)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--pin", required=True)
    ap.add_argument("--label", default="")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--nt", type=int, default=100_000)
    ap.add_argument("--nlist", type=int, default=1024)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("anytime_verdicts: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.src))
    sys.path.insert(1, ROOT)
    import chip_smoke as cs
    from repro_torch.engine import EngineConfig, SearchEngine
    from repro_torch.kernels import ops
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    ds, engine, _ = cs.ivf_engine(torch, args, max(cs.BUCKETS))
    cfg = EngineConfig(nprobe=cs.AT_NPROBE, probe_policy="margin",
                       margin_tau=cs.AT_TAU, early_exit=True,
                       scan_impl="auto", rerank_mult=cs.RERANK_MULT,
                       rerank_impl="auto")
    at = SearchEngine(engine.index, base=engine.base,
                      base_norms=engine.base_norms, config=cfg)

    def emit(**rec):
        print(json.dumps({"label": args.label, **rec}), flush=True)

    def buckets(verdicts: str) -> None:
        for qq in cs.BUCKETS:
            q = ds.queries[:qq]
            lat = []
            for _ in range(TIMED):
                t0 = time.perf_counter()
                at.search_jit(q, cs.K)
                torch.cuda.synchronize()
                lat.append((time.perf_counter() - t0) * 1e3)
            runs = sorted((cs.breakdown(torch, lambda: at.search_jit(
                q, cs.K)) for _ in range(PROFILED)), key=lambda r: r[1])
            _, busy, n_ops, rows = runs[len(runs) // 2]
            emit(verdicts=verdicts, q=qq, g=qq * cs.AT_NPROBE,
                 busy_ms=busy, busy_ms_all=[r[1] for r in runs],
                 device_ops=n_ops, latency_ms_median=sorted(lat)[TIMED // 2],
                 top_ops=[[name[:60], ms] for name, ms in rows[:3]])

    ops.clear_autotune_cache()
    for qq in cs.BUCKETS:              # warm-up: the sweeps run here
        at.search_jit(ds.queries[:qq], cs.K)
    torch.cuda.synchronize()
    for key, tuned in sorted(ops.autotune_cache().items(), key=str):
        emit(key=list(key), verdict=f"{tuned.impl}@{tuned.tile_n}",
             timings_us=dict(tuned.timings_us))
    buckets("fresh")
    if not os.path.exists(args.pin):
        os.makedirs(os.path.dirname(os.path.abspath(args.pin)),
                    exist_ok=True)
        ops.save_autotune_cache(args.pin)
    ops.clear_autotune_cache()
    ops.load_autotune_cache(args.pin)
    for key, tuned in sorted(ops.autotune_cache().items(), key=str):
        emit(key=list(key), pinned=f"{tuned.impl}@{tuned.tile_n}")
    buckets("pinned")
    return 0


if __name__ == "__main__":
    sys.exit(main())

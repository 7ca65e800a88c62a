#!/usr/bin/env python3
"""Device times of the port's K2 (stream re-rank), K3 (in-place stream
scan) and K5 (gathered select scan) at the shapes ``chip_smoke.py`` holds
them at, for the ``repro_torch`` package under ``--src``. Run on two trees
in one call, in turns (old, new, new, old), it compares two versions of
the kernels on one card:

    python3 tools/time_port_kernels.py --src src [--label new] [--seed 0]

K2: a 1,000,000 x 128 f32 base (standard normal), R = 40 candidates, k =
10, at every (Q, tile_r) of ``chip_smoke.K2_SHAPES``. K3: (G, 16, 16) u8
LUTs over a (1024, 4096, 8) u8 store in place, ~5% -1 probes, tile 1024.
K5: (G, 4096, 8) u8 codes and (G, 16, 16) u8 LUTs, tile 1024. K3 and K5 at
G = 32 and 4096, and at G = 4096 also cold: a 128 MB buffer (more than the
50 MB L2) is written before each timed call. Each kernel is held against
its plain version first. Prints the card's name and power limit, then one
JSON line a shape with the profiler's device ms a call. Needs a CUDA card;
imports neither jax nor the JAX package.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--label", default="")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("time_port_kernels: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.src))
    sys.path.insert(1, ROOT)
    import chip_smoke as cs
    from repro_torch.kernels import rerank_kernel as rk
    from repro_torch.kernels import select_kernel as sk
    from repro_torch.kernels import stream_grouped_kernel as sgk
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    base = torch.randn(1_000_000, 128, device=dev, generator=gen)
    norms = (base * base).sum(-1)
    for qq, tile in cs.K2_SHAPES:
        q, cand, xn, _ = cs.k2_inputs(torch, args.seed, base, norms, qq, tile)

        def kernel():
            return rk.rerank_stream_topk(base, q, cand, xn, k=cs.K,
                                         tile_r=tile)

        got = [t.cpu().numpy() for t in kernel()]
        want = [t.cpu().numpy() for t in rk.rerank_stream_topk_plain(
            base, q, cand, xn, k=cs.K, tile_r=tile)]
        tol = cs.K2_RTOL * ((q * q).sum(-1) + xn.max(dim=1).values)
        cs.assert_tie_aware(*got, *want, tol.cpu().numpy(),
                            f"K2 Q={qq} tile={tile}")
        ms = cs.device_ms(torch, kernel, "rerank_kernel", 50)
        print(json.dumps({"label": args.label, "kernel": "K2", "q": qq,
                          "tile": tile, "device_ms": ms}), flush=True)
    rng = np.random.default_rng(args.seed)
    flush = torch.empty(32 << 20, dtype=torch.int32, device=dev)  # 128 MB
    store = torch.as_tensor(rng.integers(0, 256, (1024, 4096, 8), np.uint8),
                            device=dev)
    for g in (32, 4096):
        table = torch.as_tensor(rng.integers(0, 256, (g, 16, 16), np.uint8),
                                device=dev)
        codes = torch.as_tensor(rng.integers(0, 256, (g, 4096, 8), np.uint8),
                                device=dev)
        probes_np = rng.integers(0, 1024, g).astype(np.int32)
        probes_np[rng.random(g) < 0.05] = -1
        probes = torch.as_tensor(probes_np, device=dev)

        def k3():
            return sgk.fastscan_stream_grouped(table, store, probes,
                                               tile_n=1024)

        def k5():
            return sk.fastscan_select_tree_grouped(table, codes, tile_n=1024)

        for what, kernel, plain, name in (
                ("K3", k3, lambda: sgk.fastscan_stream_grouped_plain(
                    table, store, probes, tile_n=1024),
                 "stream_grouped_kernel"),
                ("K5", k5, lambda: sk.fastscan_grouped_plain(
                    table, codes, tile_n=1024), "select_grouped_kernel")):
            if not torch.equal(kernel(), plain()):
                raise AssertionError(f"{what} G={g}: kernel != plain")
            ms = cs.device_ms(torch, kernel, name, 20)
            print(json.dumps({"label": args.label, "kernel": what, "g": g,
                              "device_ms": ms}), flush=True)
            if g == 4096:
                def cold(kernel=kernel):
                    flush.fill_(1)
                    return kernel()

                ms = cs.device_ms(torch, cold, name, 20)
                print(json.dumps({"label": args.label, "kernel": what,
                                  "g": g, "l2": "cold", "device_ms": ms}),
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

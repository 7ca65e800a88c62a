#!/usr/bin/env python3
"""Device times of K8 (the PQ decode attention) at the six LM paths' shapes
``chip_smoke.py`` times it at, for the ``repro_torch`` package under
``--src``. Run on two trees in one call, in turns (old, new, new, old), it
compares two versions of the kernel on one card:

    python3 tools/time_k8.py --src src [--label new] [--seed 0] [--reps 3]

Each shape is B = 8, Smax = 4,096, bf16 queries and codebooks, the q8 LUT,
the last decode's live positions of its path (qwen3 2,111; zamba2,
internvl2 and musicgen 2,079; dbrx and llama4 2,063), random codes and
codebooks from ``--seed`` (K8's work does not depend on the codes'
values). The kernel is held against its plain version first (within
``chip_smoke.K8_RTOL``), then timed as ``chip_smoke.graph_ms`` times it:
20 back-to-back calls captured as one CUDA graph, replays timed by CUDA
events, ``--reps`` times; and the profiler's device ms of each pass. Prints
the card's name and power limit, then one JSON line a shape. Needs a CUDA card; imports neither jax nor the JAX
package.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# path: (KV heads, g, M, dsub, live positions), as chip_smoke.py's phases
SHAPES = {"lm": (8, 2, 64, 2, 2111), "zamba2": (32, 1, 40, 2, 2079),
          "internvl2": (2, 7, 32, 2, 2079), "musicgen": (24, 1, 32, 2, 2079),
          "dbrx": (8, 6, 64, 2, 2063), "llama4": (8, 5, 64, 2, 2063)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--label", default="")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("time_k8: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.src))
    sys.path.insert(1, ROOT)
    import chip_smoke as cs
    from repro_torch.kernels import pq_decode_kernel as pqk
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    for i, (what, (kv, g, m, dsub, live)) in enumerate(SHAPES.items()):
        path = cs.k8_inputs(torch, args.seed + i, b=cs.LM_BATCH,
                            smax=cs.LM_MAX_SEQ, kv=kv, g=g, m=m, dsub=dsub,
                            positions=[live - 1], q8=True,
                            dtype=torch.bfloat16)

        def kernel(path=path):
            return pqk.pq_decode(*path, chunk=2048, out_dtype=torch.bfloat16)

        got = kernel().float()
        want = pqk.pq_decode_plain(*path, chunk=2048,
                                   out_dtype=torch.bfloat16).float()
        scale = want.abs().amax(-1, keepdim=True).clamp_min(1e-30)
        err = float(((got - want).abs() / scale).max())
        if not err <= cs.K8_RTOL["bfloat16"]:
            raise AssertionError(f"K8 {what}: kernel != plain ({err})")
        ms = [cs.graph_ms(torch, kernel, 20) for _ in range(args.reps)]
        # the profiler's device ms a call of each of the kernel's launches
        # (a kernel of the split design has two; None where none ran)
        passes = {name: cs.device_ms(torch, kernel, name, 20)
                  for name in ("pq_decode_kernel_split",
                               "pq_decode_kernel_combine")}
        print(json.dumps({"label": args.label, "kernel": "K8", "path": what,
                          "kv": kv, "g": g, "m": m, "live": live,
                          "max_err": err, "graph_ms": ms,
                          "profiler_ms": passes}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

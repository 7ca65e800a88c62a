#!/usr/bin/env python3
"""The meshless LM decode step's time on the card for the ``repro_torch``
package under ``--src``: each arch's full config in bf16 on seeded random
weights, an exact prefill of B = 8 x 2,048 tokens into a 4,096-position
cache, then the decode step as replays of its captured graph (CUDA events
over 20 replays) and eagerly (host clock over 10 synchronised steps). Run
on two trees in one call, in turns (old, new, new, old), it compares two
versions of the model code on one card:

    python3 tools/time_decode_step.py --src src [--label new] \\
        [--arch qwen3-1.7b --arch musicgen-medium]

Prints the card's name and power limit, then one JSON line: {arch:
[graph ms, eager ms]}. Needs a CUDA card; imports neither jax nor the JAX
package. Give each tree its own ``REPRO_TORCH_BUILD_DIR`` where their
kernel sources differ.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("qwen3-1.7b", "internvl2-1b", "musicgen-medium")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--label", default="")
    ap.add_argument("--arch", action="append", default=None)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    from repro_torch import configs
    from repro_torch.kernels import _build
    from repro_torch.models import model as ml
    from repro_torch.models.decode_graph import DecodeGraph
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    _build.load_library()
    b, s, smax = 8, 2048, 4096
    out = {}
    for arch in args.arch or ARCHS:
        cfg = configs.get_config(arch)
        params = ml.init_lm(cfg, generator=torch.Generator(
            device="cuda").manual_seed(0), device="cuda")
        prompts = torch.as_tensor(np.random.default_rng(0).integers(
            0, cfg.vocab, (b, s), dtype=np.int32), device="cuda")
        with torch.inference_mode():
            logits, cache = ml.prefill(params, prompts, cfg, max_seq=smax)
            graph = DecodeGraph(params, cache, cfg, b)
            tok = torch.argmax(logits[:, :cfg.vocab], -1)
            pos = torch.full((b,), s, dtype=torch.int32, device="cuda")
            for _ in range(3):
                graph.step(tok, pos)
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(20):
                graph.step(tok, pos)
            end.record()
            end.synchronize()
            graph_ms = start.elapsed_time(end) / 20
            for _ in range(2):
                ml.decode_step(params, cache, tok, pos, cfg)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(10):
                ml.decode_step(params, cache, tok, pos, cfg)
            torch.cuda.synchronize()
            eager_ms = (time.perf_counter() - t0) / 10 * 1e3
        out[arch] = [round(graph_ms, 4), round(eager_ms, 3)]
        del params, cache, graph
        torch.cuda.empty_cache()
    print(json.dumps({"label": args.label, "ms": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

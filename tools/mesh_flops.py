"""The pod cells' per-device counts against the one-card counts of the
same cells: how much of a step the mesh's rules replicate.

    PYTHONPATH=src python tools/mesh_flops.py build/dryrun_mesh [--jobs 4]

Reads every cell that ``python -m repro_torch.launch.dryrun --mesh pod |
multipod | both`` counted per device (a JSON with a roofline) under the
given directory, counts the same (arch, shape, kv) cell on one card on
the meta device (``dryrun.count_cell``, once a cell for both meshes) and
prints a markdown table: per-device matmul FLOPs x chips over the
one-card matmul FLOPs (the replication; 1 where the rules split every
product), the same ratio of each matmul op, the wire bytes a device, the
bound, the bottleneck and the MFU bound. Exits 1 if any ratio is under
1 (a device would do less than its share). Nothing touches a card.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import glob
import json
import os
import sys

from repro_torch import configs
from repro_torch.launch import dryrun


def _one_card(key: tuple) -> tuple[tuple, dict]:
    arch, shape, kv = key
    cfg = configs.get_config(arch)
    if kv:
        cfg = cfg.replace(kv_pq=kv == "pq")
    seq, batch, kind = dryrun.SHAPES[shape]
    costs = dryrun.count_cell(cfg, kind, batch, seq)
    return key, {k: v for k, v in costs.flops_by_op.items()
                 if k in dryrun.ca.MATMUL_OPS}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("out_dir", nargs="?", default="build/dryrun_mesh")
    ap.add_argument("--jobs", type=int, default=1)
    args = ap.parse_args(argv)
    cells = []
    for path in sorted(glob.glob(os.path.join(args.out_dir, "*.json"))):
        with open(path) as f:
            c = json.load(f)
        if c.get("mesh") in dryrun.POD_MESHES and c.get("roofline"):
            cells.append(c)
    keys = sorted({(c["arch"], c["shape"], c["kv_override"]) for c in cells},
                  key=str)
    with concurrent.futures.ProcessPoolExecutor(args.jobs) as pool:
        one = dict(pool.map(_one_card, keys))
    print("| arch | shape | kv | mesh | matmul FLOPs/dev | x chips / one "
          "card | by op | wire GB/dev | t_bound | bottleneck | MFU bound |")
    print("|---|---|---|---|---|---|---|---|---|---|---|")
    low = []
    for c in cells:
        want = one[(c["arch"], c["shape"], c["kv_override"])]
        chips = c["chips"]
        ratio = c["matmul_flops"] * chips / sum(want.values())
        by_op = ", ".join(
            f"{k} {v * chips / want[k]:.3f}"
            for k, v in sorted(c["matmul_by_op"].items()) if want.get(k))
        r = c["roofline"]
        t = max(r["t_compute_s"], r["t_memory_s"], r["t_collective_s"])
        kv = "pq" if c["kv_pq"] else "exact"
        print(f"| {c['arch']} | {c['shape']} | {kv} | {c['mesh']} "
              f"| {c['matmul_flops']:.4e} | {ratio:.4f} | {by_op} "
              f"| {r['wire_bytes_per_dev'] / 1e9:.3f} | {t * 1e3:.3f} ms "
              f"| {r['bottleneck']} | {r['mfu_bound']:.4f} |")
        if ratio < 1 - 1e-9:
            low.append((c["arch"], c["shape"], c["mesh"], ratio))
    if low:
        print(f"under one card's count: {low}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

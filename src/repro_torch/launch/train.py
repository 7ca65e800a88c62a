"""End-to-end training launcher (the port of ``repro/launch/train.py``).

    python -m repro_torch.launch.train --arch qwen3-1.7b --smoke --steps 50
    python -m repro_torch.launch.train --arch qwen3-1.7b --smoke \\
        --device cpu --steps 20
    python -m repro_torch.launch.train --arch qwen3-1.7b \\
        --global-batch 8 --seq-len 2048 --microbatches 2 --steps 8 \\
        --ckpt-dir build/ckpt --ckpt-every 4

Runs on the CUDA card unless ``--device cpu``. The full configs train at
their published widths, depth and remat; on one 80 GB H100, qwen3-1.7b
trains whole at 8 x 2,048 tokens a step in 2 microbatches (the bf16
parameters, f32 moments and f32 accumulator hold ~32.5 GB). The weights
start random from seed 0, as the reference's do.

``--dry-run`` counts the arch's train_4k cell on the meta device and
prints its roofline on one H100 (``launch/dryrun.py``; no card needed, and
none is touched), as the reference's lowers it for its TPU mesh. With
``--multi-pod`` it sizes the cell per device on the reference's (2, 16,
16) mesh instead, as the reference's launcher lowers its multipod cell,
and counts its step per device over a fake group of the mesh's ranks
(``dryrun.count_mesh_cell``): the per-device roofline.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch import configs
from repro_torch.launch import dryrun, report
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import train_loop

def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--dry-run", action="store_true",
                    help="count the train_4k cell on the meta device and "
                    "print its roofline on one H100 instead of training")
    ap.add_argument("--multi-pod", action="store_true",
                    help="with --dry-run: size and count the cell per "
                    "device on the (2, 16, 16) mesh")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    if args.dry_run:
        if args.multi_pod:
            cell = dryrun.run_cell(args.arch, "train_4k", mesh="multipod")
            print(report.per_device_table([cell]))
        else:
            cell = dryrun.run_cell(args.arch, "train_4k")
            print(report.roofline_table([cell]))
        return 0

    cfg = (configs.get_smoke_config(args.arch) if args.smoke
           else configs.get_config(args.arch))
    ocfg = opt_lib.AdamWConfig(lr=args.lr, total_steps=args.steps,
                               warmup_steps=max(1, args.steps // 20))
    state, history = train_loop.train(
        cfg, steps=args.steps, global_batch=args.global_batch,
        seq_len=args.seq_len, ocfg=ocfg, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every, microbatches=args.microbatches,
        device=args.device)
    if history:
        print(f"[train] done: final loss {history[-1]['loss']:.4f} "
              f"over {len(history)} steps")
    else:
        print(f"[train] done: the checkpoint is at step {args.steps} already")
    return 0


if __name__ == "__main__":
    sys.exit(main())

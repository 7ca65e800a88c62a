"""End-to-end LM training on the PyTorch/CUDA port: train a smoke-scale
config with checkpoints, stop as a preemption would, then resume from the
checkpoint and finish, showing that restart works.

    PYTHONPATH=src python examples/train_lm_torch.py                # the card
    PYTHONPATH=src python examples/train_lm_torch.py --device cpu
    PYTHONPATH=src python examples/train_lm_torch.py --device cpu \\
        --arch zamba2-2.7b --steps 40

Every arch of ``repro_torch.configs`` trains through ``--arch`` at its
smoke config (dense, MoE, the frontend stubs from tokens alone, Mamba2 /
zamba2 and RWKV6). The full configs train through
``python -m repro_torch.launch.train``.
"""
import argparse
import tempfile

from repro_torch import configs
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import train_loop


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args()

    cfg = configs.get_smoke_config(args.arch)
    print(f"== training {cfg.name} ({cfg.param_count()/1e6:.1f}M params) ==")
    ocfg = opt_lib.AdamWConfig(lr=1e-3, total_steps=args.steps,
                               warmup_steps=args.steps // 10)
    kw = dict(global_batch=args.global_batch, seq_len=args.seq_len,
              ocfg=ocfg, ckpt_every=max(10, args.steps // 10),
              device=args.device)

    with tempfile.TemporaryDirectory() as ckpt_dir:
        # phase 1: train to 60% with checkpoints
        state, hist = train_loop.train(cfg, steps=int(args.steps * 0.6),
                                       ckpt_dir=ckpt_dir, **kw)
        print(f"-- simulated preemption at step {len(hist)} --")
        # phase 2: resume from the checkpoint and finish
        state, hist2 = train_loop.train(cfg, steps=args.steps,
                                        ckpt_dir=ckpt_dir, **kw)
    first = hist[0]["loss"]
    last = hist2[-1]["loss"]
    print(f"loss: {first:.3f} -> {last:.3f} over {args.steps} steps "
          f"(resumed across a restart at step {hist2[0]['step']})")
    assert last < first, "training failed to reduce loss"


if __name__ == "__main__":
    main()

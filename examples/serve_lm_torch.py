"""Serve an LM with batched requests on the PyTorch/CUDA port: the exact KV
cache against the paper's 4-bit-PQ KV cache (decode attention through the
K8 kernel on the card), comparing the tokens and the cache bytes. A hybrid
(zamba2) or attention-free (rwkv6) arch is served with its exact cache
only, as the reference's example serves it. The frontend archs
(internvl2-1b, musicgen-medium) serve from tokens alone, as the
reference's ``serve_batch`` does.

    PYTHONPATH=src python examples/serve_lm_torch.py            # smoke, card
    PYTHONPATH=src python examples/serve_lm_torch.py --device cpu
    PYTHONPATH=src python examples/serve_lm_torch.py --device cpu \\
        --arch zamba2-2.7b
    PYTHONPATH=src python examples/serve_lm_torch.py --full \\
        --arch qwen3-1.7b --batch 8 --prompt-len 2048 --tokens 64
    PYTHONPATH=src python examples/serve_lm_torch.py --full \
        --arch dbrx-132b --batch 8 --prompt-len 2048 --tokens 16

The MoE archs do not fit one 80 GB card whole (215.6 GB for
llama4-scout-17b-a16e and 263.2 GB for dbrx-132b in bf16): ``--full``
serves them at every published width with the depth cut to
``configs.ONE_CARD_LAYERS``, and says so.

The weights are random (a seeded generator): no checkpoint is loaded, so
the tokens are not text and the agreement is a figure, not a quality claim.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.device import resolve_device
from repro_torch.kernels import pq_decode_kernel as pqk
from repro_torch.launch import serve as serve_lib
from repro_torch.models import model as model_lib


def cache_bytes(cache) -> int:
    tensors = cache.values() if isinstance(cache, dict) else cache
    return sum(t.numel() * t.element_size() for t in tensors)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-32b")
    ap.add_argument("--full", action="store_true",
                    help="the full config (default: the smoke config)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=12)
    ap.add_argument("--device", default=None,
                    help="cpu, or the CUDA card when omitted")
    args = ap.parse_args()

    dev = resolve_device(args.device)
    cfg = (configs.get_config(args.arch) if args.full
           else configs.get_smoke_config(args.arch))
    layers = configs.ONE_CARD_LAYERS.get(cfg.name) if args.full else None
    if layers:
        print(f"reduced: n_layers {cfg.n_layers} -> {layers}")
        cfg = cfg.replace(n_layers=layers)
    print(f"== serving {cfg.name} on {dev}: {args.batch} requests of "
          f"{args.prompt_len} tokens, {args.tokens} new tokens each ==")
    params = model_lib.init_lm(
        cfg, generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    rng = np.random.default_rng(0)
    prompts = torch.as_tensor(
        rng.integers(0, cfg.vocab, (args.batch, args.prompt_len), np.int32),
        device=dev)
    max_seq = args.prompt_len + args.tokens

    stats = {}
    exact_cfg = cfg.replace(kv_pq=False)
    toks_exact = serve_lib.serve_batch(exact_cfg, params, prompts,
                                       args.tokens, stats=stats)
    print(f"exact: prefill {stats['prefill_s']:.3f} s, decode "
          f"{stats['decode_s'] / max(stats['decode_steps'], 1) * 1e3:.2f} ms"
          " a step")

    if cfg.block_type != "attn":
        c_exact = model_lib.init_cache(exact_cfg, args.batch, max_seq,
                                       device=dev)
        print("arch is attention-free/hybrid: PQ-KV applies to attention "
              "blocks only")
        print(f"cache bytes: {cache_bytes(c_exact) / 1e6:.2f}MB")
        print("generated:", toks_exact[:, :8].cpu().numpy(), "...")
        return

    pq_cfg = cfg.replace(kv_pq=True)
    launches = pqk.launches
    t0 = time.perf_counter()
    toks_pq = serve_lib.serve_batch(pq_cfg, params, prompts, args.tokens,
                                    generator=torch.Generator().manual_seed(7),
                                    stats=stats)
    print(f"pq: calibrate {stats['calibrate_s']:.3f} s, prefill "
          f"{stats['prefill_s']:.3f} s, decode "
          f"{stats['decode_s'] / max(stats['decode_steps'], 1) * 1e3:.2f} ms"
          f" a step ({time.perf_counter() - t0:.2f} s in all; "
          f"{pqk.launches - launches} K8 launches)")
    c_exact = model_lib.init_cache(exact_cfg, args.batch, max_seq, device=dev)
    c_pq = model_lib.init_cache(pq_cfg, args.batch, max_seq, device=dev)
    exact_b = cache_bytes(c_exact)
    pq_b = cache_bytes((c_pq.k_codes, c_pq.v_codes))
    agree = float((toks_exact == toks_pq).float().mean())
    print(f"cache bytes: exact={exact_b / 1e6:.2f}MB pq={pq_b / 1e6:.2f}MB "
          f"({exact_b / pq_b:.1f}x smaller)")
    print(f"token agreement exact-vs-pq: {agree:.2f} (random weights; "
          "codebooks calibrated on this model's activations)")
    print("exact:", toks_exact[0, :10].cpu().numpy())
    print("pq:   ", toks_pq[0, :10].cpu().numpy())


if __name__ == "__main__":
    main()

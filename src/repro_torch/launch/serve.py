"""Batched LM serving: prefill, then a greedy decode loop, over the exact
or the 4-bit PQ KV cache, or a recurrent family's states (the port of
``repro/launch/serve.py``).

    python -m repro_torch.launch.serve --arch qwen3-1.7b --smoke --tokens 16
    python -m repro_torch.launch.serve --arch qwen3-1.7b --batch 8 \\
        --prompt-len 2048 --tokens 64
    python -m repro_torch.launch.serve --arch rwkv6-3b --batch 8
    python -m repro_torch.launch.serve --arch dbrx-132b --smoke

Every arch of ``repro_torch.configs`` serves: dense, MoE, the frontend
stubs (served from tokens alone: the reference's ``serve_batch`` takes no
``frontend_embeds``), Mamba2 / zamba2 and RWKV6.

Runs on the CUDA card unless ``--device cpu``; on the card each decode step
is one replay of a captured CUDA graph (``models/decode_graph.py``, the
counterpart of the reference's ``jax.jit`` of the step), on the CPU the
step runs eagerly. The weights are random, drawn from a seeded generator:
no checkpoint is loaded.

``--dry-run [--shape decode_32k]`` counts the arch's cell on the meta
device and prints its roofline on one H100 (``launch/dryrun.py``; no card
needed, and none is touched), as the reference's lowers it for its TPU
mesh. With ``--multi-pod`` it sizes the cell per device on the
reference's (2, 16, 16) mesh instead, as the reference's launcher lowers
its multipod cell, and counts its step per device over a fake group of
the 512 ranks (FLOPs, bytes, collective wire bytes, a roofline).
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.device import resolve_device
from repro_torch.launch import dryrun, report
from repro_torch.models import kvcache as kvc
from repro_torch.models import model as model_lib
from repro_torch.models.decode_graph import DecodeGraph


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@torch.inference_mode()
def calibrate_pq_cache(generator: torch.Generator, params, cfg, batch: int,
                       max_seq: int, sample_tokens: int = 256
                       ) -> kvc.PQKVCache:
    """Calibrate PQ codebooks from K/V activations on a random prompt: an
    exact prefill of 2 x ``sample_tokens`` tokens (numpy, seed 0, as the
    reference draws them), k-means per (layer, KV head, sub-space) seeded
    by ``generator`` (a CPU one), codebooks cast to bf16."""
    dev = params.embedding.device
    rng = np.random.default_rng(0)
    toks = torch.as_tensor(
        rng.integers(0, cfg.vocab, (2, sample_tokens), np.int32), device=dev)
    exact_cfg = cfg.replace(kv_pq=False)
    _, cache = model_lib.prefill(params, toks, exact_cfg,
                                 max_seq=sample_tokens)
    m = cfg.resolved_kv_pq_m
    l, b, s, kv, hd = cache.k.shape
    k_cb = torch.stack([kvc.calibrate_kv_codebooks(
        generator, cache.k[i].reshape(b * s, kv, hd), m) for i in range(l)])
    v_cb = torch.stack([kvc.calibrate_kv_codebooks(
        generator, cache.v[i].reshape(b * s, kv, hd), m) for i in range(l)])
    empty = model_lib.init_cache(cfg, batch, max_seq, device=dev)
    return kvc.PQKVCache(empty.k_codes, empty.v_codes,
                         k_cb.to(torch.bfloat16), v_cb.to(torch.bfloat16))


def calibrate_hybrid_codebooks(generator: torch.Generator, params, cfg,
                               tokens: torch.Tensor) -> dict:
    """A hybrid's shared-attention PQ codebooks in bf16, ``{"attn_k_cb",
    "attn_v_cb"}`` of (G, KV, M, 16, dsub): an exact prefill of ``tokens``
    (B, S), then k-means per (group, KV head, sub-space) on its K/V, a
    group at a time, seeded by ``generator`` (a CPU one). ``serve_batch``
    calibrates none for a hybrid, as the reference's does not; the caller
    hands them to ``prefill(pq_cache=...)``."""
    _, exact = model_lib.prefill(params, tokens, cfg.replace(kv_pq=False),
                                 max_seq=tokens.shape[1])
    out = {}
    for name in ("attn_k", "attn_v"):
        x = exact[name]
        g, b, s, kv, hd = x.shape
        out[name + "_cb"] = torch.stack([kvc.calibrate_kv_codebooks(
            generator, x[gi].reshape(b * s, kv, hd), cfg.resolved_kv_pq_m)
            for gi in range(g)]).to(torch.bfloat16)
    return out


@torch.inference_mode()
def serve_batch(cfg, params, prompts: torch.Tensor, gen_tokens: int,
                max_seq: int | None = None,
                generator: torch.Generator | None = None, *,
                return_logits: bool = False, stats: dict | None = None):
    """Greedy-decode ``gen_tokens`` for a (B, S) batch of prompts; returns
    (B, gen_tokens) tokens, the lowest index among equal top logits (and,
    with ``return_logits``, the (B, gen_tokens, Vpad) logits each token was
    picked from). With ``cfg.kv_pq`` the attention family's codebooks are
    calibrated first (``generator``, a CPU one, default seed 0); a hybrid
    with ``cfg.kv_pq`` is refused, as the reference refuses it.

    On the card the decode steps replay one captured CUDA graph; on the
    CPU they run eagerly. ``stats``, when given, gets the seconds of
    calibration, prefill and decode (the device synchronized at each
    boundary) and the steps, and on the card ``capture_s``, the graph's
    warm-up and capture (inside ``decode_s``).
    """
    b, s = prompts.shape
    max_seq = max_seq or (s + gen_tokens)
    dev = prompts.device
    if cfg.kv_pq and cfg.block_type == "mamba2" and cfg.shared_attn_every:
        # the reference's serve_batch calibrates for block_type "attn" only
        # (repro/launch/serve.py:50), and its prefill then asserts on the
        # missing codebooks (repro/models/model.py:211-213)
        raise NotImplementedError(
            f"{cfg.name}: serve_batch calibrates PQ codebooks for the "
            "attention family only, as the reference's does; serve the "
            "hybrid with kv_pq=False, or prefill it through "
            "models.model.prefill(pq_cache={'attn_k_cb', 'attn_v_cb'}) "
            "with calibrated codebooks (ROADMAP Queue 3)")
    t0 = time.perf_counter()
    pq_cache = None
    if cfg.kv_pq and cfg.block_type == "attn":
        pq_cache = calibrate_pq_cache(
            generator if generator is not None
            else torch.Generator().manual_seed(0), params, cfg, b, max_seq)
    if stats is not None:
        _sync(dev)
        stats["calibrate_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
    logits, cache = model_lib.prefill(params, prompts, cfg, max_seq=max_seq,
                                      pq_cache=pq_cache)
    if stats is not None:
        _sync(dev)
        stats["prefill_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
    kept = [logits] if return_logits else None
    out = [torch.argmax(logits[:, :cfg.vocab], dim=-1)]
    graph = (DecodeGraph(params, cache, cfg, b) if dev.type == "cuda"
             else None)
    for i in range(gen_tokens - 1):
        pos = torch.full((b,), s + i, dtype=torch.int32, device=dev)
        if graph is not None:
            logits = graph.step(out[-1], pos)
        else:
            logits, cache = model_lib.decode_step(params, cache, out[-1], pos,
                                                  cfg)
        if return_logits:
            kept.append(logits)
        out.append(torch.argmax(logits[:, :cfg.vocab], dim=-1))
    tokens = torch.stack(out, dim=1)
    if stats is not None:
        _sync(dev)
        stats["decode_s"] = time.perf_counter() - t0
        stats["decode_steps"] = gen_tokens - 1
        if graph is not None:
            stats["capture_s"] = graph.capture_seconds()
    if return_logits:
        return tokens, torch.stack(kept, dim=1)
    return tokens


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="cpu, or the CUDA card when omitted")
    ap.add_argument("--dry-run", action="store_true",
                    help="count the --shape cell on the meta device and "
                    "print its roofline on one H100 instead of serving")
    ap.add_argument("--multi-pod", action="store_true",
                    help="with --dry-run: size and count the cell per device "
                    "on the (2, 16, 16) mesh")
    ap.add_argument("--shape", default="decode_32k",
                    choices=list(dryrun.SHAPES))
    args = ap.parse_args(argv)

    if args.dry_run:
        if args.multi_pod:
            cell = dryrun.run_cell(args.arch, args.shape, mesh="multipod")
            print(report.per_device_table([cell]))
        else:
            cell = dryrun.run_cell(args.arch, args.shape)
            print(report.roofline_table([cell]))
        return 0
    dev = resolve_device(args.device)
    cfg = (configs.get_smoke_config(args.arch) if args.smoke
           else configs.get_config(args.arch))
    rng = np.random.default_rng(0)
    prompts = torch.as_tensor(
        rng.integers(0, cfg.vocab, (args.batch, args.prompt_len), np.int32),
        device=dev)
    params = model_lib.init_lm(
        cfg, generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    t0 = time.perf_counter()
    tokens = serve_batch(cfg, params, prompts, args.tokens)
    _sync(dev)
    dt = time.perf_counter() - t0
    print(f"[serve] generated {tuple(tokens.shape)} tokens in {dt:.2f}s "
          f"({args.batch * args.tokens / dt:.1f} tok/s) on {dev}")
    print(tokens.cpu().numpy())
    return 0


if __name__ == "__main__":
    sys.exit(main())

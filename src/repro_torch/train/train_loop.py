"""The train step and the fault-tolerant training loop (the port of
``repro/train/train_loop.py``).

- Microbatch gradient accumulation: the global batch is split on axis 0,
  each microbatch's gradients taken by ``torch.autograd.grad`` and summed
  into f32 buffers as ``g.float() / microbatches``, as the reference's
  ``acc_body`` does, before one optimizer update.
- Checkpoint and restart (atomic, keep-k, asynchronous): a resume is bit
  for bit, given deterministic kernels (on the card,
  ``torch.use_deterministic_algorithms(True)`` with
  ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` set before the process's first
  cuBLAS call: the embedding gather's backward accumulates with atomics
  otherwise).
- A straggler watchdog: a step-time EMA; a step slower than
  ``factor`` x EMA fires a callback (at scale: re-issue the shard to a
  backup host; the (step, host)-keyed pipeline of ``data.tokens`` lets
  any host recompute any shard).
- The PQ gradient codec's error-feedback state, created and checkpointed
  with ``grad_compress=True`` but not applied, as in the reference
  (ROADMAP Queue 3).

The step runs eagerly, the counterpart of the reference's ``jax.jit``.
"""
from __future__ import annotations

import time
from typing import Callable, NamedTuple

import torch

from repro_torch.data import tokens as tok
from repro_torch.device import resolve_device
from repro_torch.launch import sharding as shd
from repro_torch.models import layers as ll
from repro_torch.models import model as model_lib
from repro_torch.models.config import ModelConfig
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train import grad_compress as gc_lib
from repro_torch.train import optimizer as opt_lib


class TrainState(NamedTuple):
    params: ll.Params
    opt: opt_lib.AdamWState
    ef_error: dict | None = None   # error-feedback state (grad compression)


def accumulate_grads(params: ll.Params, batch: dict, cfg: ModelConfig,
                     microbatches: int = 1) -> tuple[dict, torch.Tensor, dict]:
    """(grads keyed like the parameters, the loss, the metrics) of one
    global batch. With one microbatch the gradients are in the
    parameters' dtype; with more, the mean of the microbatches' in f32
    and the metrics are the last microbatch's, as in the reference.

    Over a mesh (DTensor parameters and batch) each gradient comes back
    at its parameter's placements: the partial sums that the backward
    leaves over the batch's mesh dimensions are reduced into the
    parameter's shards (a reduce-scatter for a weight sharded over
    "data", FSDP's; an all-reduce for one whole there), and the f32
    accumulators and the loss are placed as the parameters and the loss
    are."""
    named = list(params.named_parameters())
    leaves = [p for _, p in named]

    def grads_of(mbatch):
        loss, metrics = model_lib.loss_fn(params, mbatch, cfg)
        gs = torch.autograd.grad(loss, leaves, allow_unused=True)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            [torch.zeros_like(p) if g is None else _placed_as(g, p)
             for p, g in zip(leaves, gs)]

    if microbatches == 1:
        loss, metrics, gs = grads_of(batch)
        return {n: g for (n, _), g in zip(named, gs)}, loss, metrics
    b = batch["tokens"].shape[0]
    assert b % microbatches == 0
    per = b // microbatches
    # a placed batch is taken whole once (an all-gather of its rows over
    # the batch's mesh dims), so that microbatch i holds the global rows
    # [i per, (i + 1) per) placed as the batch is, as on one device
    whole = {k: v.full_tensor() if shd.is_placed(v) else v
             for k, v in batch.items()}
    acc = {n: torch.zeros_like(p, dtype=torch.float32, requires_grad=False)
           for n, p in named}
    loss = None
    for i in range(microbatches):
        mbatch = {k: shd.placed_like(v[i * per:(i + 1) * per], batch[k])
                  for k, v in whole.items()}
        l, metrics, gs = grads_of(mbatch)
        for (n, _), g in zip(named, gs):
            acc[n] += g.float() / microbatches
        del gs
        if loss is None:
            loss = torch.zeros_like(l, dtype=torch.float32)
        loss = loss + l / microbatches
    return acc, loss, metrics


def _placed_as(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """The gradient ``g`` at the placements of its parameter ``p`` where
    both are DTensors; else ``g``."""
    if shd.is_placed(g) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(placements=p.placements)
    return g


def make_train_step(cfg: ModelConfig, ocfg: opt_lib.AdamWConfig,
                    microbatches: int = 1) -> Callable:
    """The (state, batch) -> (state, metrics) step: gradients of the
    global batch (``accumulate_grads``), then one AdamW update in place.
    The parameters must be trainable (``layers.set_trainable``)."""

    def step(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        grads, loss, metrics = accumulate_grads(state.params, batch, cfg,
                                                microbatches)
        params, opt, opt_metrics = opt_lib.apply_updates(
            state.params, grads, state.opt, ocfg)
        return TrainState(params, opt, state.ef_error), \
            {**metrics, **opt_metrics, "loss": loss}

    return step


class StragglerWatchdog:
    """Step-time EMA; flags steps slower than factor x EMA (backup-task hook)."""

    def __init__(self, factor: float = 3.0, alpha: float = 0.2,
                 on_straggler: Callable[[int, float, float], None] | None = None):
        self.factor = factor
        self.alpha = alpha
        self.ema: float | None = None
        self.events: list[tuple[int, float, float]] = []
        self.on_straggler = on_straggler

    def observe(self, step: int, dt: float) -> bool:
        is_straggler = False
        if self.ema is not None and dt > self.factor * self.ema:
            is_straggler = True
            self.events.append((step, dt, self.ema))
            if self.on_straggler:
                self.on_straggler(step, dt, self.ema)
            # do not poison the EMA with the outlier
        else:
            self.ema = dt if self.ema is None else (
                (1 - self.alpha) * self.ema + self.alpha * dt)
        return is_straggler


def init_train_state(cfg: ModelConfig, seed: int, device: torch.device,
                     grad_compress: bool = False) -> TrainState:
    """Trainable parameters drawn from ``seed`` (a generator on
    ``device``), zero moments, and a zero error state with
    ``grad_compress``."""
    params = ll.set_trainable(model_lib.init_lm(
        cfg, generator=torch.Generator(device=device).manual_seed(seed),
        device=device))
    return TrainState(params, opt_lib.init_state(params),
                      gc_lib.init_error(params) if grad_compress else None)


def train(cfg: ModelConfig, *, steps: int, global_batch: int, seq_len: int,
          ocfg: opt_lib.AdamWConfig | None = None, ckpt_dir: str | None = None,
          ckpt_every: int = 0, microbatches: int = 1, seed: int = 0,
          grad_compress: bool = False,
          codec: gc_lib.PQGradCodec | None = None,
          log: Callable[[str], None] = print,
          device: str | torch.device | None = None
          ) -> tuple[TrainState, list[dict]]:
    """Single-process training loop with checkpoint and restart, on
    ``device`` (None = the CUDA card)."""
    dev = resolve_device(device)
    ocfg = ocfg or opt_lib.AdamWConfig(total_steps=steps)
    pipe_cfg = tok.TokenPipelineConfig(vocab=cfg.vocab, seq_len=seq_len,
                                       global_batch=global_batch, seed=seed)

    state = init_train_state(cfg, seed, dev, grad_compress)
    start_step = 0
    checkpointer = None
    if ckpt_dir:
        checkpointer = ckpt_lib.AsyncCheckpointer(ckpt_dir)
        last = ckpt_lib.latest_step(ckpt_dir)
        if last is not None:
            start_step, state = ckpt_lib.restore(ckpt_dir, state, step=last)
            log(f"[train] resumed from step {start_step}")

    step_fn = make_train_step(cfg, ocfg, microbatches)
    watchdog = StragglerWatchdog()
    codec = codec or gc_lib.PQGradCodec()
    history: list[dict] = []

    for step in range(start_step, steps):
        batch = tok.batch_at_step(pipe_cfg, step, dev)
        t0 = time.perf_counter()
        state, metrics = step_fn(state, dict(batch._asdict()))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        watchdog.observe(step, dt)

        if grad_compress and state.ef_error is not None:
            # the reference's loop does not compress either: its body is
            # `pass` here (compression "is applied inside examples/dist_opt
            # flows", which do not exist), so ef_error stays at zero; the
            # port mirrors that (ROADMAP Queue 3)
            pass

        rec = {k: float(v) for k, v in metrics.items()}
        rec.update(step=step, dt=dt)
        history.append(rec)
        if step % max(1, steps // 10) == 0:
            log(f"[train] step {step}: loss={rec['loss']:.4f} "
                f"gnorm={rec['grad_norm']:.3f} dt={dt*1e3:.0f}ms")
        if checkpointer and ckpt_every and (step + 1) % ckpt_every == 0:
            checkpointer.save(step + 1, state)
    if checkpointer:
        checkpointer.wait()
        if ckpt_every:
            checkpointer.save(steps, state)
            checkpointer.wait()
    return state, history

"""Deterministic synthetic LM token pipeline (the port of
``repro/data/tokens.py``).

Host-sharded (each host draws only its slice of the global batch),
deterministic in (step, host) so any host can re-issue any shard after a
failure or for a straggler's backup task, and wrapped in a double-buffered
prefetch iterator.

The token stream is a mixture of Zipfian unigrams and a Markov bigram
chain, which gives a non-degenerate loss curve (uniform noise trains to a
flat log(V) at once and hides optimizer bugs). ``_host_batch`` is the
reference's numpy code, kept here as a copy, so the same (seed, step,
host) gives the same tokens in both packages, bit for bit; the batch is
then moved to an explicit device (None = the CUDA card).

``input_specs_lm`` gives the batch's shape stand-ins for the dry-run:
tensors on the meta device, which hold no data (``launch/dryrun.py``).
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator, NamedTuple

import numpy as np
import torch

from repro_torch.device import resolve_device


class TokenBatch(NamedTuple):
    tokens: torch.Tensor   # (B, S) int32 inputs
    targets: torch.Tensor  # (B, S) int32 next-token targets
    mask: torch.Tensor     # (B, S) float32 loss mask


class TokenPipelineConfig(NamedTuple):
    vocab: int
    seq_len: int
    global_batch: int
    host_count: int = 1
    host_id: int = 0
    seed: int = 0
    zipf_a: float = 1.2


def _host_batch(cfg: TokenPipelineConfig, step: int) -> np.ndarray:
    """Deterministic (step, host)-keyed batch of shape (B/host, S+1)."""
    assert cfg.global_batch % cfg.host_count == 0
    b = cfg.global_batch // cfg.host_count
    rng = np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, cfg.host_id]))
    v = cfg.vocab
    # zipf unigram stream
    uni = rng.zipf(cfg.zipf_a, size=(b, cfg.seq_len + 1)).astype(np.int64)
    uni = (uni - 1) % v
    # markov overlay: with p=0.5, next token = f(prev) for a fixed cheap map
    prev = np.concatenate([uni[:, :1], uni[:, :-1]], axis=1)
    markov = (prev * 2654435761 + 12345) % v
    pick = rng.random((b, cfg.seq_len + 1)) < 0.5
    out = np.where(pick, markov, uni)
    return out.astype(np.int32)


def batch_at_step(cfg: TokenPipelineConfig, step: int,
                  device: str | torch.device | None = None) -> TokenBatch:
    """The host's batch of ``step`` on ``device`` (None = the CUDA card)."""
    dev = resolve_device(device)
    raw = torch.from_numpy(_host_batch(cfg, step))
    tokens = raw[:, :-1].contiguous().to(dev)
    targets = raw[:, 1:].contiguous().to(dev)
    return TokenBatch(tokens=tokens, targets=targets,
                      mask=torch.ones(tokens.shape, dtype=torch.float32,
                                      device=dev))


def input_specs_lm(vocab: int, seq_len: int, global_batch: int
                   ) -> dict[str, torch.Tensor]:
    """Meta-device stand-ins of a batch for the dry-run (no allocation)."""
    del vocab
    shape = (global_batch, seq_len)
    meta = torch.device("meta")
    return {"tokens": torch.empty(shape, dtype=torch.int32, device=meta),
            "targets": torch.empty(shape, dtype=torch.int32, device=meta),
            "mask": torch.empty(shape, dtype=torch.float32, device=meta)}


class PrefetchIterator:
    """Background-thread prefetch of the deterministic pipeline (depth 2)."""

    def __init__(self, cfg: TokenPipelineConfig, start_step: int = 0,
                 depth: int = 2, device: str | torch.device | None = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self._step
        while not self._stop.is_set():
            batch = batch_at_step(self.cfg, step, self.device)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator[tuple[int, TokenBatch]]:
        return self

    def __next__(self) -> tuple[int, TokenBatch]:
        return self._q.get()

    def close(self):
        self._stop.set()
        self._thread.join(timeout=5.0)

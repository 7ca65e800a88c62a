"""The LM decode step as a captured CUDA graph (the counterpart of the
reference's ``jax.jit(decode_step)`` in ``repro/launch/serve.py``).

A ``DecodeGraph`` holds one model, one cache and one
``engine.graphs.GraphCache``. Its key is (config, cache kind, batch,
max_seq, identity of every parameter and cache tensor): one graph a key,
captured at the first ``step`` and replayed after. Tokens and position go
into the graph's static device buffers; the step writes the cache in place
(``transformer``'s decode paths), so every replay reads and writes the same
storage. The logits are returned as a clone (the graph's own live in its
pool and change under the next replay), and a replay adds the kernel
launches it holds (K8 on a PQ cache) to their counters.

``GraphCache`` runs the step once eagerly before the capture (the warm-up
that readies cuBLAS and the allocator on the capture stream). That would
advance the recurrent states twice, so the warm-up saves them and puts
them back; the attention caches' writes at the position are the same
values the replay writes again. A capture that fails raises: there is no
eager fallback.
"""
from __future__ import annotations

import torch

from repro_torch.engine.graphs import GraphCache, state_identity
from repro_torch.launch import sharding as shd
from repro_torch.models import kvcache as kvc
from repro_torch.models import model as model_lib
from repro_torch.models.config import ModelConfig

# the cache entries a step overwrites with a function of themselves
RECURRENT = ("h", "conv", "s", "tm_prev", "cm_prev")


def cache_tensors(cache) -> list[torch.Tensor]:
    """Every tensor of an attention (named tuple) or recurrent (dict)
    cache, in a fixed order."""
    if isinstance(cache, dict):
        return [cache[k] for k in sorted(cache)]
    return list(cache)


def cache_kind(cache) -> str:
    if isinstance(cache, kvc.PQKVCache):
        return "pq"
    if isinstance(cache, kvc.ExactKVCache):
        return "exact"
    return "pq" if "attn_k_codes" in cache else "exact"


def cache_max_seq(cache) -> int | None:
    """The cache's positions (None for RWKV6, which keeps no positions)."""
    if isinstance(cache, dict):
        for key in ("attn_k", "attn_k_codes"):
            if key in cache:
                return cache[key].shape[2]
        return None
    return cache[0].shape[2]


class DecodeGraph:
    """``decode_step(params, cache, ., ., cfg)`` replayed as one CUDA graph
    on the card that holds ``params`` and ``cache``."""

    def __init__(self, params, cache, cfg: ModelConfig, batch: int):
        dev = params.embedding.device
        if dev.type != "cuda":
            raise ValueError(f"a decode graph needs the CUDA card, not {dev}")
        if shd.is_placed(params.embedding):
            raise NotImplementedError(
                "a decode graph over placed tensors: the decode over a mesh "
                "runs eagerly (launch.dryrun.mesh_cell)")
        self.params, self.cache, self.cfg = params, cache, cfg
        self.graphs = GraphCache(dev)
        self._state = tuple(params.parameters()) + tuple(cache_tensors(cache))
        self._recurrent = ([cache[k] for k in RECURRENT if k in cache]
                           if isinstance(cache, dict) else [])
        self.key = (cfg, cache_kind(cache), batch, cache_max_seq(cache),
                    state_identity(self._state))

    def _step(self, tokens: torch.Tensor, position: torch.Tensor):
        if torch.cuda.is_current_stream_capturing():
            return model_lib.decode_step(self.params, self.cache, tokens,
                                         position, self.cfg)[0]
        # the eager warm-up before the capture: leave the states as found
        saved = [t.clone() for t in self._recurrent]
        logits = model_lib.decode_step(self.params, self.cache, tokens,
                                       position, self.cfg)[0]
        for t, s in zip(self._recurrent, saved):
            t.copy_(s)
        return logits

    @torch.inference_mode()
    def step(self, tokens: torch.Tensor, position: torch.Tensor
             ) -> torch.Tensor:
        """One decode step through the graph: (B, Vpad) logits (a clone);
        the cache is updated in place. Under a mesh of several ranks it
        raises: a graph over collectives is not captured, the decode there
        runs eagerly."""
        mesh, _ = shd._get_ctx()
        if mesh is not None and mesh.size > 1:
            raise NotImplementedError(
                f"a decode graph under {mesh}: the decode over several ranks "
                "runs eagerly (launch.dryrun.mesh_cell)")
        return self.graphs.run(self.key, self._state, self._step,
                               (tokens, position))

    def capture_seconds(self) -> float:
        """Warm-up + capture wall time of the graph (0 before the first
        step)."""
        return sum(self.graphs.capture_seconds().values())

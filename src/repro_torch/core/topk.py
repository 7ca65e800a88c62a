"""Top-k selection with the reference's tie order
(counterpart of ``repro.core.topk``).

The reference relies on ``jax.lax.top_k`` putting the LOWEST index first
among equal values, and the stream kernels rebuild that order inside their
selections. ``torch.topk`` does not keep it, and quantized ADC sums tie all
the time, so every selection here runs ``torch.topk`` over distinct int64
keys that carry the index below the value.

Conventions: distances float32 ascending on return; ids/positions int32;
-1 = no candidate (distance +inf).
"""
from __future__ import annotations

import torch


def smallest_k(dists: torch.Tensor, k: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., N) float -> (vals (..., k), ids (..., k) int32) ascending by
    distance, lowest index first among equal values.

    A ``torch.topk`` over int64 keys instead of a full sort: the value's
    order-preserving float32 bits (-0.0 taken as +0.0) in the high 32 bits,
    the index in the low 32. The keys are distinct, so the order is exact,
    the one ``jax.lax.top_k`` of the negated row gives.
    """
    n = dists.shape[-1]
    if k > n:
        raise ValueError(f"k={k} exceeds the {n} entries")
    if not dists.is_floating_point() or dists.element_size() > 4:
        raise ValueError(f"want float32 or narrower distances, got "
                         f"{dists.dtype}")
    bits = (dists.float() + 0.0).view(torch.int32)      # -0.0 + 0.0 = +0.0
    # negative floats: flip the magnitude bits so that int order is float order
    keys = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).to(torch.int64)
    keys <<= 32
    keys |= torch.arange(n, dtype=torch.int64, device=dists.device)
    _, pick = torch.topk(keys, k, dim=-1, largest=False, sorted=True)
    return torch.gather(dists, -1, pick), pick.to(torch.int32)


def tournament_topk(dists: torch.Tensor, k: int, block: int = 1024
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Blocked top-k: each block's k smallest, then the k smallest of
    those. dists (Q, N) -> (vals (Q, k), ids (Q, k) i32) ascending, the
    order ``smallest_k`` gives over the whole row (ties: lowest index)."""
    q, n = dists.shape
    if n <= max(block, 2 * k):
        return smallest_k(dists, k)
    pad = (-n) % block
    if pad:
        dists = torch.nn.functional.pad(dists, (0, pad), value=torch.inf)
    nb = dists.shape[1] // block
    vals, idx = smallest_k(dists.reshape(q, nb, block), min(k, block))
    gidx = idx + (torch.arange(nb, dtype=idx.dtype, device=idx.device)
                  * block)[None, :, None]
    mvals, midx = smallest_k(vals.reshape(q, -1), k)
    return mvals, torch.gather(gidx.reshape(q, -1), 1, midx.long())


def merge_topk(vals, ids, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The shard merge of ``distributed_topk``: each shard's (Q, >=k)
    results, in shard order, laid side by side as an ``all_gather`` along
    axis 1 lays them, then the k smallest (ties: the lowest shard, then the
    lowest position within it). Each shard's own top-k is taken first."""
    picked_v, picked_i = [], []
    for v, i in zip(vals, ids):
        lv, li = smallest_k(v, min(k, v.shape[-1]))
        picked_v.append(lv)
        picked_i.append(torch.gather(i, 1, li.long()))
    mvals, midx = smallest_k(torch.cat(picked_v, dim=1), k)
    return mvals, torch.gather(torch.cat(picked_i, dim=1), 1, midx.long())


def distributed_topk(local_dists: torch.Tensor, local_ids: torch.Tensor,
                     k: int, group) -> tuple[torch.Tensor, torch.Tensor]:
    """Merge shard-local results across a ``torch.distributed`` process
    group, one shard a rank: each rank's (Q, k') results (the same shape
    on every rank; k' = k in the sharded engine) are all-gathered and
    merged as ``merge_topk`` merges them (rank order is shard order), so
    every rank returns the same (Q, k). Wire cost: 2k' values a query and
    rank."""
    import torch.distributed as dist
    size = dist.get_world_size(group)
    out = []
    for local in (local_dists.contiguous(), local_ids.contiguous()):
        parts = [torch.empty_like(local) for _ in range(size)]
        dist.all_gather(parts, local, group=group)
        out.append(parts)
    return merge_topk(*out, k)


def masked_topk(dists: torch.Tensor, valid: torch.Tensor, k: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k over entries where valid; invalid slots return inf/-1."""
    d = torch.where(valid, dists, torch.inf)
    vals, idx = smallest_k(d, k)
    return vals, torch.where(torch.isfinite(vals), idx, -1)


def margin_prune_probes(vals: torch.Tensor, probes: torch.Tensor, tau
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Adaptive-nprobe mask: drop probes outside the per-query margin.

    vals: (Q, P) coarse centroid distances aligned with probes (Q, P);
    slots already -1 must carry +inf vals. A probe survives iff its distance
    is within ``(1 + tau) * d0`` of the query's best probed centroid ``d0``.
    ``tau`` is a scalar or (Q,), f32; ``tau = +inf`` keeps every probe
    (guarded explicitly so ``d0 == 0`` never turns ``0 * inf`` into NaN),
    and the best probe always survives whatever tau is.

    Returns (probes with pruned slots set to -1, per-query pruned count).
    """
    tau = torch.as_tensor(tau, dtype=torch.float32, device=vals.device)
    if tau.ndim == 1:
        tau = tau[:, None]
    present = probes >= 0
    d = torch.where(present, vals, torch.inf)
    d0 = torch.amin(d, dim=1, keepdim=True)
    keep = (d <= d0 * (1.0 + tau)) | torch.isposinf(tau) | (d <= d0)
    pruned = torch.sum(present & ~keep, dim=1, dtype=torch.int32)
    return torch.where(keep, probes, -1), pruned


def gather_ids(ids: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Map masked_topk positions back to ids, preserving the -1 sentinel.

    ids: (Q, N); pos: (Q, k) (-1 = no candidate).
    """
    got = torch.gather(ids, -1, torch.clamp_min(pos, 0).long())
    return torch.where(pos >= 0, got, -1)

"""HNSW graph: host-side (numpy) construction and a batched beam search in
torch (counterpart of ``repro.core.hnsw``).

The coarse quantizer of the paper's Table 1 pipeline (IVF + HNSW + 4-bit
PQ). The build is the reference's numpy code, kept here as a copy, so the
same centroids and seed give the same graph bit for bit. The search is a
fixed-shape beam search in torch ops on the graph's device: a dense (Q, n)
visited mask, fixed-degree padded adjacency and a fixed iteration count,
with no host synchronisation and no host-to-device copy (scalar writes
go through ``scatter_``), so it captures into a CUDA graph.

Every selection keeps the reference's tie order: ``core.topk.smallest_k``
puts the lowest index first among equal values, as ``lax.top_k`` of the
negated row does, and ``torch.argmin`` takes the first minimum, as
``jnp.argmin`` does.

One departure, on purpose: the reference's level-0 visited update scatters
a padded neighbour (-1) onto node 0, writing node 0's old flag back after a
real neighbour 0 has set it, so node 0 is never marked visited and re-enters
the beam on every expansion of a padded row. Here only real neighbours are
marked (pads write to a spare column ``n`` that nothing reads), so a node
enters the beam once. Where no level-0 row is padded (nlist > 2·m at the
reference's build) the two searches are the same.
"""
from __future__ import annotations

import heapq
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import topk as topk_mod
from repro_torch.device import resolve_device


class HNSWGraph(NamedTuple):
    vectors: torch.Tensor   # (N, D) float32, the indexed points
    level0: torch.Tensor    # (N, 2M) int32 adjacency, -1 padded
    uppers: tuple           # per level > 0: (ids (n_l,) i32 ascending,
    #                         adj (n_l, M) i32 of global ids, -1 padded)
    entry: int              # entry point id (top level)

    @property
    def n(self) -> int:
        return self.vectors.shape[0]

    def tensors(self) -> tuple:
        """Every tensor of the graph, in a fixed order."""
        return (self.vectors, self.level0,
                *(t for level in self.uppers for t in level))


# ---------------------------------------------------------------------------
# construction (numpy, offline; the reference's code)
# ---------------------------------------------------------------------------

def _search_layer_np(vecs, adj, q, entry, ef):
    """Classic single-layer beam search (numpy, used only during build)."""
    visited = {entry}
    d0 = float(np.sum((vecs[entry] - q) ** 2))
    cand = [(d0, entry)]           # min-heap of candidates to expand
    best = [(-d0, entry)]          # max-heap (neg) of current best ef
    while cand:
        d, u = heapq.heappop(cand)
        if d > -best[0][0] and len(best) >= ef:
            break
        for v in adj[u]:
            if v < 0 or v in visited:
                continue
            visited.add(v)
            dv = float(np.sum((vecs[v] - q) ** 2))
            if len(best) < ef or dv < -best[0][0]:
                heapq.heappush(cand, (dv, v))
                heapq.heappush(best, (-dv, v))
                if len(best) > ef:
                    heapq.heappop(best)
    out = sorted((-nd, v) for nd, v in best)
    return [v for _, v in out], [d for d, _ in out]


def build_hnsw(vectors, m: int = 16, ef_construction: int = 64,
               seed: int = 0, *, device: str | torch.device | None = None
               ) -> HNSWGraph:
    """Insert-based HNSW build over (N, D) float32 rows (numpy or a
    tensor), onto ``device`` (None = the CUDA card; raises without one)."""
    dev = resolve_device(device)
    if isinstance(vectors, torch.Tensor):
        vectors = vectors.detach().cpu().numpy()
    vectors = np.asarray(vectors, np.float32)
    rng = np.random.default_rng(seed)
    n, _ = vectors.shape
    ml = 1.0 / np.log(m)
    levels = np.minimum(
        (-np.log(rng.uniform(1e-12, 1.0, n)) * ml).astype(np.int64), 8)
    max_level = int(levels.max())
    deg0, degu = 2 * m, m
    adj = [np.full((n, deg0 if l == 0 else degu), -1, np.int64)
           for l in range(max_level + 1)]

    def connect(l, u, neighbors):
        cap = adj[l].shape[1]
        sel = neighbors[:cap]
        adj[l][u, :len(sel)] = sel
        for v in sel:  # back-links with pruning by distance
            row = adj[l][v]
            free = np.where(row < 0)[0]
            if len(free):
                row[free[0]] = u
            else:  # replace the farthest back-link if u is closer
                dists = np.sum((vectors[row] - vectors[v]) ** 2, axis=1)
                du = np.sum((vectors[u] - vectors[v]) ** 2)
                worst = int(np.argmax(dists))
                if du < dists[worst]:
                    row[worst] = u

    entry = 0
    entry_level = int(levels[0])
    for i in range(1, n):
        li = int(levels[i])
        ep = entry
        # greedy descent through levels above li
        for l in range(entry_level, li, -1):
            if l > max_level:
                continue
            changed = True
            while changed:
                changed = False
                neigh = adj[l][ep]
                neigh = neigh[neigh >= 0]
                if len(neigh):
                    dn = np.sum((vectors[neigh] - vectors[i]) ** 2, axis=1)
                    j = int(np.argmin(dn))
                    if dn[j] < np.sum((vectors[ep] - vectors[i]) ** 2):
                        ep = int(neigh[j])
                        changed = True
        # insert at levels min(li, entry_level) .. 0
        for l in range(min(li, entry_level), -1, -1):
            cands, _ = _search_layer_np(vectors, adj[l], vectors[i], ep,
                                        ef_construction)
            connect(l, i, np.asarray(cands, np.int64))
            ep = cands[0]
        if li > entry_level:
            entry, entry_level = i, li

    def t(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)

    uppers = []
    for l in range(1, max_level + 1):
        ids = np.where(levels >= l)[0]
        uppers.append((t(ids, np.int32), t(adj[l][ids], np.int32)))
    return HNSWGraph(vectors=t(vectors, np.float32),
                     level0=t(adj[0], np.int32), uppers=tuple(uppers),
                     entry=int(entry))


# ---------------------------------------------------------------------------
# search (torch, batched, fixed shape)
# ---------------------------------------------------------------------------

def _sqd(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    diff = a - b
    return torch.sum(diff * diff, dim=-1)


def _pick(x: torch.Tensor, at: torch.Tensor) -> torch.Tensor:
    """x (Q, C), at (Q,) -> x[q, at[q]]."""
    return torch.gather(x, 1, at[:, None])[:, 0]


def search_hnsw(g: HNSWGraph, q: torch.Tensor, *, ef: int = 64,
                topk: int = 10, iters: int = 0
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched HNSW search. q: (Q, D) -> (dists (Q, topk) f32 ascending,
    ids (Q, topk) i32; -1 / +inf past the nodes found).

    Greedy descent above level 0 (3 hops a level), then a beam of ``ef``
    at level 0 expanded ``iters`` times (default 2·ef), the nearest
    unexpanded entry each time.
    """
    if q.ndim == 1:
        q = q[None]
    nq, n = q.shape[0], g.n
    iters = iters or 2 * ef
    vecs = g.vectors

    # --- greedy descent through the upper levels
    ep = torch.full((nq,), g.entry, dtype=torch.int32, device=q.device)
    for ids, adj in reversed(g.uppers):
        for _ in range(3):
            # left side, as jnp.searchsorted
            pos = torch.clamp(torch.searchsorted(ids, ep), 0,
                              ids.shape[0] - 1)
            valid_row = ids[pos] == ep
            neigh = torch.where(valid_row[:, None], adj[pos], -1)   # (Q, M)
            dn = _sqd(vecs[torch.clamp_min(neigh, 0).long()], q[:, None, :])
            dn = torch.where(neigh >= 0, dn, torch.inf)
            best = torch.argmin(dn, dim=-1)
            better = _pick(dn, best) < _sqd(vecs[ep.long()], q)
            ep = torch.where(better, _pick(neigh, best), ep)

    # --- level-0 beam search; visited has a spare column n for the pads
    beam_ids = torch.full((nq, ef), -1, dtype=torch.int32, device=q.device)
    beam_ids[:, 0] = ep
    beam_d = torch.full((nq, ef), torch.inf, dtype=torch.float32,
                        device=q.device)
    beam_d[:, 0] = _sqd(vecs[ep.long()], q)
    expanded = torch.zeros((nq, ef), dtype=torch.bool, device=q.device)
    visited = torch.zeros((nq, n + 1), dtype=torch.bool, device=q.device)
    visited.scatter_(1, ep.long()[:, None], True)
    fresh_pad = torch.zeros((nq, g.level0.shape[1]), dtype=torch.bool,
                            device=q.device)
    for _ in range(iters):
        # the nearest unexpanded beam entry
        cand_d = torch.where(expanded | (beam_ids < 0), torch.inf, beam_d)
        sel = torch.argmin(cand_d, dim=-1)
        sel_id = _pick(beam_ids, sel)
        has = torch.isfinite(_pick(cand_d, sel))
        expanded.scatter_(1, sel[:, None], True)
        neigh = g.level0[torch.clamp_min(sel_id, 0).long()]       # (Q, deg)
        neigh = torch.where((neigh >= 0) & has[:, None], neigh, -1)
        real = neigh >= 0
        col = torch.where(real, neigh, n).long()
        fresh = real & ~torch.gather(visited, 1, col)
        visited.scatter_(1, col, True)
        dn = _sqd(vecs[torch.clamp_min(neigh, 0).long()], q[:, None, :])
        dn = torch.where(fresh, dn, torch.inf)
        # merge (beam, new) -> best ef, lowest position first among ties
        beam_d, pos = topk_mod.smallest_k(torch.cat([beam_d, dn], dim=1), ef)
        pos = pos.long()
        beam_ids = torch.gather(torch.cat([beam_ids, neigh], dim=1), 1, pos)
        expanded = torch.gather(torch.cat([expanded, fresh_pad], dim=1), 1,
                                pos)
    vals, pos = topk_mod.smallest_k(beam_d, topk)
    return vals, torch.gather(beam_ids, 1, pos.long())

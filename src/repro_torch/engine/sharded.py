"""Shard-parallel search over a partitioned index (counterpart of
``repro.engine.sharded``).

The posting lists are partitioned round-robin into S shards
(``core.lists.partition_lists``). Every shard runs the single-host
engine's stages over its own lists: flat coarse over its centroids, the
grouped 4-bit scan (``engine.scan_candidates``; the stream kernel K1 reads
the shard's lists in place) and the optional exact re-rank
(``rerank.finalize_candidates``; K2 reads the shard's own base slice).
The shards' (Q, k) results meet in the merge of ``core.topk``: laid side
by side in shard order, then one top-k, so ties go to the lowest shard.

The base is partitioned too (``core.lists.partition_base``): each shard
holds only the rows of the lists it owns, its list ids are local rows,
and ``gids_s`` maps them back to global ids just before the merge.

Two ways to run the same per-shard function:
  - ``group=None``: the shards run in turn on the engine's device, and the
    stats are summed (the reference's ``vmap`` path);
  - ``group=<torch.distributed process group>`` of S ranks: each rank runs
    the shard of its rank; the results are all-gathered and merged, the
    stats all-reduced (the reference's ``shard_map`` path), so every rank
    returns the same result.

Live mutation (and ``attach_wal``) as in the single-host engine: ``upsert``
routes rows with the global centroid table through the fixed-shape encoder
(the same list, so shard ``g % S`` and local list ``g // S``, and the same
code bytes as the single-host engine), appends into the owning shard's
spare slots and base rows; ``delete`` tombstones slots; ``compact`` rebuilds every shard's lists
and base slice tombstone-free. Writes go into the engine's tensors in
place, under the lock that every search also takes, so no search sees a
half-written epoch.
"""
from __future__ import annotations

import threading
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import ivf as ivf_mod
from repro_torch.core import lists as lists_mod
from repro_torch.core import topk as topk_mod
from repro_torch.core.kmeans import pairwise_sqdist
from repro_torch.core.lists import ListStore
from repro_torch.engine import rerank as rerank_mod
from repro_torch.engine.engine import (MARGIN_PROBE_FILL, QueryStats,
                                       SearchEngine, SearchResult, _Locator,
                                       combine_filter_bits,
                                       count_rows_filtered,
                                       count_rows_tombstoned, scan_candidates)
from repro_torch.kernels import ops as ops_mod


def _local_search(centroids, lists: ListStore, real, gids, codebook, base,
                  norms, member, q, fbits, live, ns, tau, *, k: int,
                  nprobe: int, r: int, scan_impl: str, rerank_impl: str,
                  remap: bool, probe_policy: str = "fixed",
                  early_exit: bool = False
                  ) -> tuple[torch.Tensor, torch.Tensor, QueryStats]:
    """One shard's pipeline: (vals (Q, k), global ids (Q, k), the shard's
    QueryStats), before the merge.

    With ``remap`` the shard's list ids are local rows into its ``base``
    slice, and ``gids`` maps the results back to global ids; without it
    (no base held) ids are global throughout. ``member`` is the shard's
    (n_ns, L) slice of the namespace table, ``fbits`` and ``live`` its
    (L, W) slices of the request's filter and of the live-row bitmap, ``ns``
    the (Q,) tenant ids; any may be None. Under ``probe_policy='margin'``
    the shard prunes against the best centroid among its own lists.
    ``lists_probed`` counts probes of real lists only: a shard with fewer
    real lists than nprobe probes padding, which is no work.
    """
    index = ivf_mod.IVFIndex(centroids=centroids, codebook=codebook,
                             lists=lists)
    nprobe_local = min(nprobe, centroids.shape[0])
    coarse_d = pairwise_sqdist(q, centroids)
    if member is not None and ns is not None:
        row = torch.clamp(ns, 0, member.shape[0] - 1).long()
        allow = (ns < 0)[:, None] | member[row]
        cvals, probes = topk_mod.masked_topk(coarse_d, allow, nprobe_local)
    else:
        cvals, probes = topk_mod.smallest_k(coarse_d, nprobe_local)
    zeros = torch.zeros((q.shape[0],), dtype=torch.int32, device=q.device)
    lists_pruned = zeros
    if probe_policy == "margin":
        probes, lists_pruned = topk_mod.margin_prune_probes(
            cvals, probes, torch.inf if tau is None else tau)
    flat_d, flat_ids, tiles_skipped = scan_candidates(
        index, q, probes, scan_impl=scan_impl, keep=(r * k) if r else k,
        filter_bits=combine_filter_bits(fbits, live), early_exit=early_exit,
        probe_fill=(MARGIN_PROBE_FILL if probe_policy == "margin" else 1.0))
    vals, out_ids, reranked = rerank_mod.finalize_candidates(
        flat_d, flat_ids, base, q, k, r, norms=norms,
        rerank_impl=rerank_impl)
    if remap:
        out_ids = torch.where(out_ids >= 0,
                              gids[torch.clamp_min(out_ids, 0).long()], -1)
    valid = probes >= 0
    safe = torch.clamp_min(probes, 0).long()
    stats = QueryStats(
        lists_probed=torch.sum(real[safe] & valid, dim=1, dtype=torch.int32),
        codes_scanned=torch.sum(lists.probed_sizes(probes), dim=1,
                                dtype=torch.int32),
        reranked=reranked,
        rows_filtered=count_rows_filtered(index, probes, fbits, live),
        rows_tombstoned=(zeros if live is None else
                         count_rows_tombstoned(index, probes, live)),
        lists_pruned=lists_pruned,
        tiles_skipped=tiles_skipped)
    return vals, out_ids, stats


class _ShardState(NamedTuple):
    """Every shard-partitioned tensor a search reads, and the counters."""

    centroids_s: torch.Tensor          # (S, L, D)
    lists_s: ListStore                 # leading shard dim; ids local with
    #                                    a base
    real_s: torch.Tensor               # (S, L) bool, False on padding
    base_s: torch.Tensor | None        # (S, R, D) or None
    gids_s: torch.Tensor               # (S, R) i32 local row -> global id
    norms_s: torch.Tensor | None       # (S, R) f32
    live_s: torch.Tensor | None        # (S, L, W) u8; None = no tombstones
    rows_used: tuple                   # base rows in use, per shard
    epoch: int
    n_tombstones: int


class ShardedEngine:
    """A ``SearchEngine``'s index partitioned across S shards.

    Every shard selects probes with flat coarse over its own centroids
    (each holds nlist/S of them, so the wrapped engine's HNSW or tree
    structure does not partition and is not carried over). With a base,
    each shard's re-rank reads only its own (R, D) slice, R ~ N/S, with its
    rows' norms. Routing for mutation uses the wrapped engine's global
    centroids through the same fixed-shape encoder, so a row lands in the
    same global list, and gets the same code bytes, as on the single-host
    engine. The shards' tensors are copies: the wrapped engine is not
    touched.
    """

    def __init__(self, engine: SearchEngine, num_shards: int):
        if num_shards < 1:
            raise ValueError(f"num_shards must be >= 1, got {num_shards}")
        self.num_shards = s = int(num_shards)
        self.device = engine.device
        self.config = engine.config
        index = engine.index
        self.codebook = index.codebook
        self.centroids = index.centroids
        centroids_s, lists_s, real_s = lists_mod.partition_lists(
            index.lists, index.centroids, s)
        if engine.base is not None:
            base_s, gids_s, local_ids, norms_s = lists_mod.partition_base(
                lists_s, engine.base, engine.base_norms)
            lists_s = lists_s._replace(ids=local_ids)
            rows_used = tuple(int(c) for c in
                              torch.sum(gids_s >= 0, dim=1).tolist())
        else:
            base_s = norms_s = None
            gids_s = torch.full((s, 1), -1, dtype=torch.int32,
                                device=self.device)
            rows_used = (0,) * s
        # a wrapped engine may carry tombstones already
        n_tomb = int(torch.sum(lists_s.sizes)
                     - torch.sum(lists_s.ids >= 0))
        self._state = _ShardState(
            centroids_s=centroids_s, lists_s=lists_s, real_s=real_s,
            base_s=base_s, gids_s=gids_s, norms_s=norms_s,
            live_s=lists_mod.live_filter_bits(lists_s) if n_tomb else None,
            rows_used=rows_used, epoch=0, n_tombstones=n_tomb)
        self._mutate_lock = threading.RLock()
        self._locator: _Locator | None = None
        self._wal = None  # persist.WALWriter, attach_wal
        # namespace membership sharded like the lists: (S, n_ns, L), padding
        # lists member-False for every tenant
        self.member_s = (None if engine.ns_member is None else
                         lists_mod.round_robin_rows(engine.ns_member.T, s, False)
                         .permute(0, 2, 1).contiguous())

    # -- the current state ---------------------------------------------------

    @property
    def centroids_s(self) -> torch.Tensor:
        return self._state.centroids_s

    @property
    def lists_s(self) -> ListStore:
        return self._state.lists_s

    @property
    def base_s(self) -> torch.Tensor | None:
        return self._state.base_s

    @property
    def gids_s(self) -> torch.Tensor:
        return self._state.gids_s

    @property
    def live_s(self) -> torch.Tensor | None:
        """Sharded live-row bitmap; None while no tombstones are held."""
        return self._state.live_s

    @property
    def cap(self) -> int:
        """Slot capacity of every (shard, list)."""
        return self._state.lists_s.cap

    @property
    def epoch(self) -> int:
        return self._state.epoch

    @property
    def n_tombstones(self) -> int:
        return self._state.n_tombstones

    # -- live mutation -------------------------------------------------------

    def attach_wal(self, wal) -> None:
        """Attach a ``persist.WALWriter`` (``SearchEngine.attach_wal``'s
        contract: each mutation logs before its first write); ``None``
        detaches."""
        with self._mutate_lock:
            self._wal = wal

    def locate(self, gid: int) -> tuple[int, int, int] | None:
        """(shard, local list, slot) of a live row, None if absent."""
        with self._mutate_lock:
            loc = self._locate()
            g = np.asarray([int(gid)], np.int64)
            if not loc.present(g)[0]:
                return None
            flat, slots = loc.find(g)
            nl = self._state.lists_s.nlist
            return int(flat[0]) // nl, int(flat[0]) % nl, int(slots[0])

    def _locate(self) -> _Locator:
        """gid -> (shard * L + local list, slot), built on first use, then
        kept current by the mutators."""
        if self._locator is None:
            st = self._state
            ids = st.lists_s.ids
            if st.base_s is not None:
                got = torch.gather(st.gids_s, 1,
                                   torch.clamp_min(ids, 0).reshape(
                                       ids.shape[0], -1).long())
                ids = torch.where(ids >= 0, got.reshape(ids.shape), -1)
            self._locator = _Locator(
                ids.reshape(-1, ids.shape[-1]).cpu().numpy())
        return self._locator

    def _write_slots(self, lists: ListStore, flat: np.ndarray,
                     slots: np.ndarray, **values) -> None:
        """lists.<name>[shard, local list, slot] = value, in place, at each
        (flat list = shard * L + local list, slot)."""
        nl = lists.nlist
        at = tuple(torch.as_tensor(a, dtype=torch.int64, device=self.device)
                   for a in (flat // nl, flat % nl, slots))
        for name, value in values.items():
            t = getattr(lists, name)
            if t is not None:
                t.index_put_(at, torch.as_tensor(value, dtype=t.dtype,
                                                 device=self.device))

    def upsert(self, ids, vecs, *, attrs=None) -> np.ndarray:
        """Insert or replace rows across the shards; the single-host
        engine's contract. Returns the (B,) i32 global list of each row.
        When a target list lacks spare slots every shard's cap grows to the
        next multiple of 8 of the need (the reference's rule: no compaction
        here); a shard out of base rows grows R to a multiple of 256. Both
        drop the autotune verdicts keyed to the old shape."""
        ids = np.asarray(ids.cpu() if isinstance(ids, torch.Tensor) else ids,
                         np.int64)
        vecs = ivf_mod.as_rows(vecs, self.device)
        if ids.ndim != 1 or vecs.ndim != 2 or ids.shape[0] != vecs.shape[0]:
            raise ValueError(
                f"upsert wants ids (B,) + vecs (B, D), got {ids.shape} and "
                f"{tuple(vecs.shape)}")
        if ids.size == 0:
            return np.empty((0,), np.int32)
        if (ids < 0).any():
            raise ValueError("upsert ids must be >= 0")
        if np.unique(ids).size != ids.size:
            raise ValueError("duplicate ids within one upsert batch")
        avals = None if attrs is None else np.asarray(attrs, np.int32)
        with self._mutate_lock, torch.no_grad():
            st = self._state
            lists_s = st.lists_s
            if avals is not None and lists_s.attrs is None:
                raise ValueError("attrs given but the store holds no attrs "
                                 "column")
            s, nl = self.num_shards, lists_s.nlist
            assign, packed = ivf_mod.encode_rows(self.centroids,
                                                 self.codebook, vecs)
            shard = assign.astype(np.int64) % s
            local = assign.astype(np.int64) // s
            loc = self._locate()
            if self._wal is not None:
                # durable before visible: nothing below refuses the batch
                self._wal.log_upsert(ids, vecs.cpu().numpy(), avals)
            n_tomb = st.n_tombstones
            hit = ids[loc.present(ids)]
            if hit.size:
                self._write_slots(lists_s, *loc.find(hit), ids=-1, attrs=-1)
                loc.drop(hit)
                n_tomb += int(hit.size)
            sizes = lists_s.sizes.cpu().numpy().astype(np.int64)
            counts = np.zeros(sizes.shape, np.int64)
            np.add.at(counts, (shard, local), 1)
            if (sizes + counts > lists_s.cap).any():
                old_cap = lists_s.cap
                new_cap = -(-int((sizes + counts).max()) // 8) * 8
                lists_s = lists_mod.grow_cap(lists_s, new_cap)
                ops_mod.clear_autotune_cache(nlist=nl, cap=old_cap)
            # slot: the list's watermark + the row's rank in the batch among
            # rows of its list (the single-host append's order)
            b = ids.shape[0]
            order = np.argsort(assign, kind="stable")
            rank = np.empty(b, np.int64)
            sa = assign[order]
            rank[order] = np.arange(b) - np.searchsorted(sa, sa, side="left")
            slots = sizes[shard, local] + rank
            base_s, gids_s, norms_s = st.base_s, st.gids_s, st.norms_s
            rows_used = st.rows_used
            slot_ids = ids
            if base_s is not None:
                # the shard's next free rows, in batch order within it
                order_j = np.argsort(shard, kind="stable")
                rank_j = np.empty(b, np.int64)
                sj = shard[order_j]
                rank_j[order_j] = (np.arange(b)
                                   - np.searchsorted(sj, sj, side="left"))
                used = np.array(rows_used, np.int64)
                rows = used[shard] + rank_j
                r_cap = base_s.shape[1]
                if rows.max() >= r_cap:
                    pad = -(-(int(rows.max()) + 1) // 256) * 256 - r_cap
                    base_s = torch.cat([base_s, base_s.new_zeros(
                        (s, pad, base_s.shape[2]))], dim=1)
                    gids_s = torch.cat([gids_s, gids_s.new_full((s, pad),
                                                                -1)], dim=1)
                    norms_s = torch.cat([norms_s, norms_s.new_zeros(
                        (s, pad))], dim=1)
                    ops_mod.clear_autotune_cache(kind="rerank", n=r_cap)
                at = (torch.as_tensor(shard, device=self.device),
                      torch.as_tensor(rows, device=self.device))
                base_s.index_put_(at, vecs)
                gids_s.index_put_(at, torch.as_tensor(
                    ids.astype(np.int32), device=self.device))
                norms_s.index_put_(at, lists_mod.base_norms(vecs))
                np.add.at(used, shard, 1)
                rows_used = tuple(int(c) for c in used)
                slot_ids = rows
            flat = shard * nl + local
            self._write_slots(
                lists_s, flat, slots, codes=packed, ids=slot_ids,
                attrs=np.full(b, -1, np.int32) if avals is None else avals)
            lists_s.sizes.add_(torch.as_tensor(counts, dtype=torch.int32,
                                               device=self.device))
            loc.put(ids, flat, slots)
            self._state = st._replace(
                lists_s=lists_s, base_s=base_s, gids_s=gids_s,
                norms_s=norms_s,
                live_s=(lists_mod.live_filter_bits(lists_s) if n_tomb
                        else None),
                rows_used=rows_used, epoch=st.epoch + 1,
                n_tombstones=n_tomb)
        return assign

    def delete(self, ids) -> int:
        """Tombstone rows by global id across the shards; unknown ids are
        ignored. Returns the number of rows deleted."""
        ids = np.unique(np.asarray(
            ids.cpu() if isinstance(ids, torch.Tensor) else ids, np.int64))
        with self._mutate_lock, torch.no_grad():
            st = self._state
            loc = self._locate()
            found = ids[loc.present(ids)]
            if not found.size:
                return 0
            if self._wal is not None:
                self._wal.log_delete(ids)
            self._write_slots(st.lists_s, *loc.find(found), ids=-1,
                              attrs=-1)
            loc.drop(found)
            self._state = st._replace(
                live_s=lists_mod.live_filter_bits(st.lists_s),
                epoch=st.epoch + 1,
                n_tombstones=st.n_tombstones + int(found.size))
            return int(found.size)

    def compact(self, cap: int | None = None) -> int:
        """Rebuild every shard's lists, and base slice, tombstone-free:
        survivors keep their slot order in each list, a shard's base rows
        re-pack in order of appearance (``partition_base``'s order) and R
        becomes the most any shard needs, rounded up to 256. Returns the
        tombstoned slots reclaimed."""
        with self._mutate_lock, torch.no_grad():
            st = self._state
            ls = st.lists_s
            s, nl = ls.ids.shape[0], ls.nlist
            flat = ListStore(*(None if t is None else
                               t.reshape((s * nl,) + tuple(t.shape[2:]))
                               for t in ls))
            if cap is not None:
                lists_mod.check_compact_cap(flat, cap)
            if self._wal is not None:
                self._wal.log_compact(cap)
            old_cap = ls.cap
            out = lists_mod.compact_lists(flat, cap=cap)
            lists_s = ListStore(*(None if t is None else
                                  t.reshape((s, nl) + tuple(t.shape[1:]))
                                  for t in out))
            base_s, gids_s, norms_s = st.base_s, st.gids_s, st.norms_s
            rows_used = st.rows_used
            if base_s is not None:
                local, js, rows, counts = lists_mod.pack_local_rows(
                    lists_s.ids)
                r_cap = max(1, -(-int(counts.max()) // 256) * 256)
                ids2 = lists_s.ids.reshape(s, -1)
                old = ids2[ids2 >= 0].long()
                base_s = st.base_s.new_zeros((s, r_cap,
                                              st.base_s.shape[2]))
                base_s[js, rows] = st.base_s[js, old]
                gids_s = st.gids_s.new_full((s, r_cap), -1)
                gids_s[js, rows] = st.gids_s[js, old]
                norms_s = st.norms_s.new_zeros((s, r_cap))
                norms_s[js, rows] = st.norms_s[js, old]
                lists_s.ids.copy_(local)
                rows_used = tuple(int(c) for c in counts.tolist())
                if r_cap != st.base_s.shape[1]:
                    ops_mod.clear_autotune_cache(kind="rerank",
                                                 n=st.base_s.shape[1])
            if lists_s.cap != old_cap:
                ops_mod.clear_autotune_cache(nlist=nl, cap=old_cap)
            self._locator = None
            self._state = st._replace(
                lists_s=lists_s, base_s=base_s, gids_s=gids_s,
                norms_s=norms_s, live_s=None, rows_used=rows_used,
                epoch=st.epoch + 1, n_tombstones=0)
            return st.n_tombstones

    # -- search ----------------------------------------------------------------

    def search(self, queries, k: int = 10, *, nprobe: int | None = None,
               rerank_mult: int | None = None, filter_bits=None,
               namespaces=None, margin_tau=None, group=None
               ) -> SearchResult:
        """Batched search with the shard merge.

        Each shard probes ``nprobe`` of its own lists, so up to S·nprobe
        lists are scanned: recall at a given nprobe is at least the
        single-host engine's. ``filter_bits`` is the (nlist, W) bitmap over
        global list ids, sharded here per request; ``namespaces`` (Q,) i32
        restricts each shard's probe selection to the tenant's lists;
        ``margin_tau`` overrides the margin width, only under
        ``probe_policy='margin'`` (each shard prunes against its own best
        centroid). ``group``: a ``torch.distributed`` process group of
        ``num_shards`` ranks, each running the shard of its rank (the
        reference's ``mesh``); None runs every shard here in turn.
        """
        cfg = self.config
        with self._mutate_lock, torch.no_grad():
            st = self._state
            q = torch.as_tensor(queries, dtype=torch.float32,
                                device=self.device)
            q = (q[None] if q.ndim == 1 else q).contiguous()
            nprobe = cfg.nprobe if nprobe is None else nprobe
            r = cfg.rerank_mult if rerank_mult is None else rerank_mult
            if r and st.base_s is None:
                raise ValueError("exact re-rank requested but the engine "
                                 "holds no base vectors (build with "
                                 "keep_base=True)")
            if margin_tau is not None and cfg.probe_policy != "margin":
                raise ValueError(
                    "margin_tau override given but probe_policy is "
                    f"{cfg.probe_policy!r}; build the wrapped engine with "
                    "EngineConfig(probe_policy='margin')")
            tau = None
            if cfg.probe_policy == "margin":
                tau = torch.as_tensor(
                    cfg.margin_tau if margin_tau is None else margin_tau,
                    dtype=torch.float32, device=self.device)
                if tau.ndim not in (0, 1) or (
                        tau.ndim == 1 and tau.shape != (q.shape[0],)):
                    raise ValueError(
                        f"margin_tau must be a scalar or ({q.shape[0]},) "
                        f"per-query widths, got shape {tuple(tau.shape)}")
            if namespaces is not None:
                if self.member_s is None:
                    raise ValueError(
                        "per-query namespaces given but the wrapped engine "
                        "was built without a namespace table")
                namespaces = torch.as_tensor(namespaces, dtype=torch.int32,
                                             device=self.device)
            fbits_s = None
            if filter_bits is not None:
                cap = st.lists_s.cap
                fb = torch.as_tensor(filter_bits, device=self.device)
                if fb.ndim != 2 or fb.shape[1] * 8 < cap:
                    raise ValueError(
                        f"filter_bits of shape {tuple(fb.shape)} too narrow "
                        f"for cap={cap}; a growth may have changed cap: "
                        "derive filters from the live store")
                fbits_s = lists_mod.partition_filter(
                    fb[:, :lists_mod.filter_words(cap)].to(torch.uint8),
                    self.num_shards)
            if group is None:
                shards = range(self.num_shards)
            else:
                import torch.distributed as dist
                if dist.get_world_size(group) != self.num_shards:
                    raise ValueError(
                        f"the process group has {dist.get_world_size(group)}"
                        f" ranks but the engine holds {self.num_shards} "
                        "shards")
                shards = (dist.get_rank(group),)
            outs = [self._local(st, j, q, fbits_s, namespaces, tau, k=k,
                                nprobe=nprobe, r=r) for j in shards]
            if group is None:
                vals, ids = topk_mod.merge_topk([o[0] for o in outs],
                                                [o[1] for o in outs], k)
                stats = QueryStats(*(torch.stack(parts).sum(
                    dim=0, dtype=torch.int32)
                    for parts in zip(*(o[2] for o in outs))))
                return SearchResult(vals, ids, stats)
            vals, ids = topk_mod.distributed_topk(outs[0][0], outs[0][1], k,
                                                  group)
            stacked = torch.stack(list(outs[0][2]))
            dist.all_reduce(stacked, group=group)
            return SearchResult(vals, ids, QueryStats(*stacked))

    def _local(self, st: _ShardState, j: int, q, fbits_s, ns, tau, *,
               k: int, nprobe: int, r: int):
        """Shard ``j``'s ``_local_search`` over ``st``."""
        cfg = self.config
        lists = ListStore(*(None if t is None else t[j] for t in st.lists_s))
        return _local_search(
            st.centroids_s[j], lists, st.real_s[j], st.gids_s[j],
            self.codebook,
            None if st.base_s is None else st.base_s[j],
            None if st.norms_s is None else st.norms_s[j],
            None if ns is None or self.member_s is None else self.member_s[j],
            q, None if fbits_s is None else fbits_s[j],
            None if st.live_s is None else st.live_s[j], ns, tau, k=k,
            nprobe=nprobe, r=r, scan_impl=cfg.scan_impl,
            rerank_impl=cfg.rerank_impl, remap=st.base_s is not None,
            probe_policy=cfg.probe_policy, early_exit=cfg.early_exit)

"""Batched search engine: coarse -> 4-bit fast-scan -> exact re-rank
(counterpart of ``repro.engine.engine``).

The serving query path, as pure functions of (coarse, index, tensors):

  1. ``coarse_probes``: flat coarse quantizer, the nprobe nearest lists,
     pruned per query by the margin policy when it is on (anytime search);
  2. ``scan_candidates``: residual u8 LUTs per (query, probe), then the
     scan impl the config names or the autotuner picks: the stream kernel
     (K1, or K4 with early exit) over the lists in place with fused
     per-tile top-kc and the optional filter bitmap, or a full-pool scan
     (``core.ivf.scan_probes``: 'ref', K5 'select', K6 'mxu' over a
     gathered copy) post-filtered;
  3. ``rerank.finalize_candidates``: the top r·k candidates re-ranked
     exactly ('gathered', the stream kernel K2, or 'auto'), then the final
     top-k;
  4. ``make_stats``: the per-query ``QueryStats`` counters.

``SearchEngine.search`` composes them eagerly; ``SearchEngine.search_jit``
replays the same pipeline as one captured CUDA graph per (shape, knobs,
presence of each optional input, state) key (``engine.graphs``, the
counterpart of the reference's fused ``jax.jit``), bit for bit equal to
``search``. Per query: optional filter bitmaps, namespaces (tenant ids
into the engine's list-membership table), a margin width.

Live mutation (the reference's ``docs/mutability.md`` contract):
``upsert`` encodes rows with the fixed-shape encoder and appends them into
spare list slots, ``delete`` tombstones rows (id -1 in place), and
``compact`` drops the tombstones. While tombstones exist the engine holds a
live-row bitmap (``live_bits``) that the scan ANDs into its filter, so a
deleted row never takes a candidate slot. The engine's first write clones
the store, base and norms it was given, so engines built over one index
stay independent. After that, a write that keeps every shape goes into the
engine's tensors in place, under the graph cache's lock and after its last
replay, so captured graphs keep serving; a write that must reallocate (the
first write's clone, another cap, a larger base) drops the engine's
graphs.
``EngineState`` is the snapshot a search reads once.

Coarse quantizers (``core.coarse``): flat, HNSW (``EngineConfig.ef`` is its
beam width) or the k-means tree, or a prebuilt object with
``search(q, nprobe)``. Namespaces are fused into the flat quantizer's probe
selection; the others' probes are masked after they are routed.

Durability (``attach_wal``, the reference's docs/persistence.md): with a
``persist.WALWriter`` attached, every mutation appends one fsync'd record
after every check that can refuse it and before its first in-place write,
outside the graph cache's lock (the fsync never stalls a search). A failed
or fenced append leaves the engine as it was.
"""
from __future__ import annotations

import numbers
import threading
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import coarse as coarse_mod
from repro_torch.core import ivf as ivf_mod
from repro_torch.core import lists as lists_mod
from repro_torch.core import topk as topk_mod
from repro_torch.core.kmeans import pairwise_sqdist
from repro_torch.core.lists import (filter_pass_sizes, filter_words,
                                    unpack_filter_mask)
from repro_torch.device import resolve_device
from repro_torch.engine import graphs as graphs_mod
from repro_torch.engine import rerank as rerank_mod
from repro_torch.kernels import ops as ops_mod
from repro_torch.kernels.ops import RERANK_IMPLS, SCAN_IMPLS

PROBE_POLICIES = ("fixed", "margin")
COARSE_KINDS = ("flat", "hnsw", "tree")
# valid-probe fraction the autotune sweep assumes under the margin policy:
# an adaptive workload's 'auto' verdict is timed (and cached) against a
# probe set with this fill instead of a dense one
MARGIN_PROBE_FILL = 0.5


class EngineConfig(NamedTuple):
    """Static search-time knobs; the reference's fields and defaults."""

    nprobe: int = 8         # lists scanned per query (the MAX under 'margin')
    rerank_mult: int = 0    # refine rerank_mult*k candidates exactly; 0 = off
    scan_impl: str = "ref"  # kernels.ops.SCAN_IMPLS
    ef: int = 64            # HNSW beam width (hnsw coarse only)
    rerank_impl: str = "gathered"  # kernels.ops.RERANK_IMPLS
    probe_policy: str = "fixed"  # 'fixed' | 'margin' (adaptive nprobe: drop
    #                         probes beyond (1 + tau) x the query's best)
    margin_tau: float = float("inf")  # 'margin' width; +inf keeps every
    #                         probe (bit-identical to 'fixed')
    early_exit: bool = False  # anytime tile pruning in the stream scan
    #                         (K4); lossless for the final top-k, no-op on
    #                         the gathered impls


_EF_DEFAULT = EngineConfig._field_defaults["ef"]


class QueryStats(NamedTuple):
    """Per-query work counters, each (Q,) int32."""

    lists_probed: torch.Tensor   # valid probes issued
    codes_scanned: torch.Tensor  # true occupancy of scanned lists
    reranked: torch.Tensor       # candidates refined exactly
    rows_filtered: torch.Tensor  # probed rows the filter excluded
    rows_tombstoned: torch.Tensor  # probed watermark slots holding deleted
    #                              rows; zeros on an unmutated engine
    lists_pruned: torch.Tensor   # probes the margin policy dropped
    tiles_skipped: torch.Tensor  # valid-probe tiles early exit skipped


class SearchResult(NamedTuple):
    dists: torch.Tensor  # (Q, k) f32 ascending
    ids: torch.Tensor    # (Q, k) i32 global ids, -1 = no candidate
    stats: QueryStats


def validate_config(config: EngineConfig, *, coarse_kind: str,
                    has_base: bool) -> None:
    """Reject nonsense config/coarse combinations at construction time."""
    if config.nprobe < 1:
        raise ValueError(f"EngineConfig.nprobe must be >= 1, got {config.nprobe}")
    if config.rerank_mult < 0:
        raise ValueError(
            f"EngineConfig.rerank_mult must be >= 0, got {config.rerank_mult}")
    if config.scan_impl not in SCAN_IMPLS:
        raise ValueError(f"EngineConfig.scan_impl {config.scan_impl!r} unknown; "
                         f"want one of {SCAN_IMPLS}")
    if config.rerank_impl not in RERANK_IMPLS:
        raise ValueError(
            f"EngineConfig.rerank_impl {config.rerank_impl!r} unknown; "
            f"want one of {RERANK_IMPLS}")
    if config.probe_policy not in PROBE_POLICIES:
        raise ValueError(
            f"EngineConfig.probe_policy {config.probe_policy!r} unknown; "
            f"want one of {PROBE_POLICIES}")
    if config.margin_tau is None or not config.margin_tau >= 0:  # rejects NaN
        raise ValueError(
            f"EngineConfig.margin_tau must be >= 0, got {config.margin_tau}")
    if config.ef < 1:
        raise ValueError(f"EngineConfig.ef must be >= 1, got {config.ef}")
    if config.ef != _EF_DEFAULT and coarse_kind != "hnsw":
        raise ValueError(
            f"EngineConfig.ef={config.ef} is set but coarse={coarse_kind!r}; "
            "ef is the HNSW beam width")
    if config.rerank_mult > 0 and not has_base:
        raise ValueError(
            f"EngineConfig.rerank_mult={config.rerank_mult} requires the raw "
            "base vectors for exact re-rank, but the engine holds none")


def coarse_probes(coarse, q: torch.Tensor, *, nprobe: int,
                  ef: int = _EF_DEFAULT,
                  ns_member: torch.Tensor | None = None,
                  namespaces: torch.Tensor | None = None,
                  probe_policy: str = "fixed",
                  margin_tau: torch.Tensor | float | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Stage 1: the nprobe nearest lists. Returns (probes (Q, nprobe) i32,
    -1 = no probe; lists_pruned (Q,) i32). An HNSW quantizer searches with
    a beam of ``max(ef, nprobe)``. Under ``probe_policy='margin'`` a probe
    survives only while its centroid distance is within
    ``(1 + margin_tau) x`` the query's best (``core.topk.
    margin_prune_probes``; scalar or (Q,) tau, None or +inf keeps all).

    Namespaces: ``ns_member`` is the engine's (n_ns, nlist) bool table and
    ``namespaces`` the (Q,) i32 tenant of each query (-1 = unrestricted).
    On the flat quantizer the restriction is fused into probe selection
    (``masked_topk`` over the allowed lists), so a tenant's scan touches
    only its own lists and a tenant with fewer than nprobe lists gets -1
    probes; with every query at -1 the result is bit for bit
    ``smallest_k``'s. Other quantizers route first and their probes of
    lists outside the tenant become -1. A tenant id past the table reads
    its last row, as the reference's clamped gather does.
    """
    restrict = ns_member is not None and namespaces is not None
    if restrict:
        row = torch.clamp(namespaces, 0, ns_member.shape[0] - 1).long()
        allow = (namespaces < 0)[:, None] | ns_member[row]
    if isinstance(coarse, coarse_mod.FlatCoarse) and restrict:
        vals, probes = topk_mod.masked_topk(
            pairwise_sqdist(q, coarse.centroids), allow, nprobe)
    else:
        if isinstance(coarse, coarse_mod.HNSWCoarse):
            vals, probes = coarse.search(q, nprobe, ef=ef)
        else:
            vals, probes = coarse.search(q, nprobe)
        if restrict:
            ok = torch.gather(allow, 1, torch.clamp_min(probes, 0).long())
            probes = torch.where(ok & (probes >= 0), probes, -1)
    if probe_policy == "margin":
        tau = torch.inf if margin_tau is None else margin_tau
        return topk_mod.margin_prune_probes(vals, probes, tau)
    return probes, torch.zeros((probes.shape[0],), dtype=torch.int32,
                               device=probes.device)


def scan_candidates(index: ivf_mod.IVFIndex, q: torch.Tensor,
                    probes: torch.Tensor, *, scan_impl: str,
                    keep: int | None = None,
                    filter_bits: torch.Tensor | None = None,
                    early_exit: bool = False, probe_fill: float = 1.0
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stage 2: quantized scan, flattened to one candidate pool per query.

    Returns (dists (Q, C) f32, ids (Q, C) i32 with -1 = pad, tiles_skipped
    (Q,) i32 -- zeros unless the stream path ran with early exit). ``keep``
    is the candidate budget the final selection takes (r*k, or k without
    re-rank): when the resolved impl is 'stream' and ``keep`` is given, the
    scan runs over the store in place with fused per-tile reduction and
    ``filter_bits`` applied before it (``core.ivf.scan_probes_stream``).
    Otherwise the full pool comes from ``core.ivf.scan_probes`` and the
    filter is applied after, the reference's post-filter oracle; both agree
    through any final selection of <= keep. ``probe_fill`` is the valid-
    probe share the 'auto' sweep assumes.
    """
    qq = probes.shape[0]
    if keep is not None:
        impl, tile_n = ops_mod.resolve_scan_impl(
            scan_impl, qq * probes.shape[1], index.lists.cap,
            2 * index.lists.codes.shape[-1], nlist=index.lists.nlist,
            probe_fill=probe_fill, device=index.lists.codes.device)
        if impl == "stream":
            out = ivf_mod.scan_probes_stream(index, q, probes, keep=keep,
                                             tile_n=tile_n,
                                             filter_bits=filter_bits,
                                             early_exit=early_exit)
            if early_exit:
                return out
            return (*out, torch.zeros((qq,), dtype=torch.int32,
                                      device=q.device))
    dists, ids = ivf_mod.scan_probes(index, q, probes, impl=scan_impl)
    if filter_bits is not None:
        ok = unpack_filter_mask(filter_bits, index.lists.cap)[
            torch.clamp_min(probes, 0).long()] & (ids >= 0)
        dists = torch.where(ok, dists, torch.inf)
        ids = torch.where(ok, ids, -1)
    return (dists.reshape(qq, -1), ids.reshape(qq, -1),
            torch.zeros((qq,), dtype=torch.int32, device=q.device))


def combine_filter_bits(filter_bits: torch.Tensor | None,
                        live_bits: torch.Tensor | None
                        ) -> torch.Tensor | None:
    """The scan's effective filter: the request's bitmap AND the engine's
    live-row bitmap; either may be None (no predicate, no tombstones) and
    drops out."""
    if live_bits is None:
        return filter_bits
    if filter_bits is None:
        return live_bits
    return filter_bits & live_bits


def _probe_sum(probes: torch.Tensor, per_list: torch.Tensor) -> torch.Tensor:
    """Sum a (nlist,) per-list counter over each query's valid probes."""
    got = per_list[torch.clamp_min(probes, 0).long()]
    return torch.sum(torch.where(probes >= 0, got, 0), dim=1,
                     dtype=torch.int32)


def count_rows_filtered(index: ivf_mod.IVFIndex, probes: torch.Tensor,
                        filter_bits: torch.Tensor | None,
                        live_bits: torch.Tensor | None = None
                        ) -> torch.Tensor:
    """(Q,) i32: probed live rows the filter excluded; zero without a
    filter. Tombstones count in ``count_rows_tombstoned``, never here."""
    if filter_bits is None:
        return torch.zeros((probes.shape[0],), dtype=torch.int32,
                           device=probes.device)
    lists = index.lists
    live = (lists.sizes if live_bits is None
            else filter_pass_sizes(lists, live_bits))
    eff = combine_filter_bits(filter_bits, live_bits)
    return _probe_sum(probes, live - filter_pass_sizes(lists, eff))


def count_rows_tombstoned(index: ivf_mod.IVFIndex, probes: torch.Tensor,
                          live_bits: torch.Tensor | None) -> torch.Tensor:
    """(Q,) i32: probed watermark slots holding tombstones; zero when the
    engine holds none (``live_bits`` is None)."""
    if live_bits is None:
        return torch.zeros((probes.shape[0],), dtype=torch.int32,
                           device=probes.device)
    lists = index.lists
    return _probe_sum(probes, lists.sizes - filter_pass_sizes(lists,
                                                              live_bits))


def make_stats(index: ivf_mod.IVFIndex, probes: torch.Tensor,
               reranked: torch.Tensor,
               filter_bits: torch.Tensor | None = None,
               live_bits: torch.Tensor | None = None,
               lists_pruned: torch.Tensor | None = None,
               tiles_skipped: torch.Tensor | None = None) -> QueryStats:
    """Work counters from the probe set and the stages' counters; a None
    anytime counter (hand composition) records zeros."""
    zeros = torch.zeros((probes.shape[0],), dtype=torch.int32,
                        device=probes.device)
    return QueryStats(
        lists_probed=torch.sum(probes >= 0, dim=1, dtype=torch.int32),
        codes_scanned=torch.sum(index.lists.probed_sizes(probes), dim=1,
                                dtype=torch.int32),
        reranked=reranked,
        rows_filtered=count_rows_filtered(index, probes, filter_bits,
                                          live_bits),
        rows_tombstoned=(zeros if live_bits is None else
                         count_rows_tombstoned(index, probes, live_bits)),
        lists_pruned=zeros if lists_pruned is None else lists_pruned,
        tiles_skipped=zeros if tiles_skipped is None else tiles_skipped)


def _pipeline(coarse, index: ivf_mod.IVFIndex, base: torch.Tensor | None,
              norms: torch.Tensor | None, ns_member: torch.Tensor | None,
              q: torch.Tensor, filter_bits: torch.Tensor | None,
              namespaces: torch.Tensor | None,
              live_bits: torch.Tensor | None = None,
              margin_tau: torch.Tensor | None = None, *, k: int, nprobe: int,
              r: int, scan_impl: str, rerank_impl: str,
              ef: int = _EF_DEFAULT, probe_policy: str = "fixed",
              early_exit: bool = False) -> SearchResult:
    """The whole query path as one function (stages 1-4 + stats). A
    namespace-excluded probe is -1, so it counts in no stat. ``live_bits``
    (the engine's live-row bitmap, present only while the store holds
    tombstones) is ANDed into the scan's filter, so the stream scan's
    per-tile budget skips deleted rows before it selects; the gathered
    impls mask them by id anyway."""
    probes, lists_pruned = coarse_probes(
        coarse, q, nprobe=nprobe, ef=ef, ns_member=ns_member,
        namespaces=namespaces, probe_policy=probe_policy,
        margin_tau=margin_tau)
    flat_d, flat_ids, tiles_skipped = scan_candidates(
        index, q, probes, scan_impl=scan_impl, keep=(r * k) if r else k,
        filter_bits=combine_filter_bits(filter_bits, live_bits),
        early_exit=early_exit,
        probe_fill=(MARGIN_PROBE_FILL if probe_policy == "margin" else 1.0))
    vals, out_ids, reranked = rerank_mod.finalize_candidates(
        flat_d, flat_ids, base, q, k, r, norms=norms, rerank_impl=rerank_impl)
    return SearchResult(dists=vals, ids=out_ids,
                        stats=make_stats(index, probes, reranked, filter_bits,
                                         live_bits, lists_pruned,
                                         tiles_skipped))


class EngineState(NamedTuple):
    """One snapshot of everything a search reads. A search reads it once,
    under the graph cache's lock, so the whole search is one epoch. A
    shape-keeping mutation writes into these tensors in place and installs
    the next snapshot (same tensors, the next epoch) under the same lock; a
    reallocating one installs new tensors."""

    index: ivf_mod.IVFIndex
    base: torch.Tensor | None
    base_norms: torch.Tensor | None
    live_bits: torch.Tensor | None  # packed live-row bitmap; None = no
    #                                 tombstones
    epoch: int                      # bumped by every mutation, from 0
    n_tombstones: int               # tombstoned slots across the lists


class _Locator:
    """Global id -> (list, slot) of every live row: two host arrays indexed
    by id, -1 where the id is absent, kept current by the mutators."""

    def __init__(self, ids: np.ndarray):
        ls, ss = np.nonzero(ids >= 0)
        gids = ids[ls, ss]
        n = int(gids.max()) + 1 if gids.size else 0
        self.list = np.full(n, -1, np.int32)
        self.slot = np.full(n, -1, np.int32)
        self.list[gids] = ls
        self.slot[gids] = ss

    def present(self, gids: np.ndarray) -> np.ndarray:
        """(B,) bool: which of ``gids`` are live."""
        ok = (gids >= 0) & (gids < self.list.size)
        ok[ok] = self.list[gids[ok]] >= 0
        return ok

    def find(self, gids: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(lists, slots) of live ``gids``."""
        return self.list[gids], self.slot[gids]

    def drop(self, gids: np.ndarray) -> None:
        self.list[gids] = -1
        self.slot[gids] = -1

    def put(self, gids: np.ndarray, lists: np.ndarray, slots: np.ndarray
            ) -> None:
        need = int(gids.max()) + 1
        if need > self.list.size:
            grow = max(need, 2 * self.list.size) - self.list.size
            self.list = np.concatenate([self.list, np.full(grow, -1,
                                                           np.int32)])
            self.slot = np.concatenate([self.slot, np.full(grow, -1,
                                                           np.int32)])
        self.list[gids] = lists
        self.slot[gids] = slots


class SearchEngine:
    """IVF + 4-bit fast-scan + exact re-rank behind one ``search(queries, k)``.

    The engine lives on the device of its index. ``base`` (the raw float
    vectors) is optional; without it re-rank requests are rejected.
    ``namespaces`` is an optional (n_ns, nlist) bool membership table, kept
    as ``ns_member``: row t = the lists holding tenant t's vectors.

    The engine is live-mutable (``upsert``, ``delete``, ``compact``; the
    module docstring). Its first write clones the store, ``base`` and
    ``base_norms`` it was given, so engines built over the same tensors
    stay independent; later writes go into those copies in place.
    ``index``, ``base``, ``base_norms`` and ``live_bits`` read the current
    ``EngineState``; assigning ``index``, ``base`` or ``base_norms``
    installs a new snapshot (over the caller's tensors until the next
    write).
    """

    def __init__(self, index: ivf_mod.IVFIndex, *,
                 base: torch.Tensor | None = None, coarse="flat",
                 config: EngineConfig | None = None, hnsw_m: int = 16,
                 ef_construction: int = 64, namespaces=None,
                 base_norms: torch.Tensor | None = None,
                 live_bits: torch.Tensor | None = None):
        """``coarse`` is one of ``COARSE_KINDS``, built here over the
        index's centroids (HNSW with ``hnsw_m`` and ``ef_construction``; the
        tree from a k-means seeded with 0), or a prebuilt quantizer (a
        ``core.coarse`` one, or any object with ``search(q, nprobe)``,
        whose ``search_jit`` then runs eagerly, as the reference's does).
        ``base_norms`` takes precomputed ``‖x‖²`` of the base rows (a
        carried-over index brings its own); they are derived when absent.
        A store that already holds tombstones gets its live-row bitmap
        here, so the first search is already exact: the packed
        ``live_bits`` it was saved with (installed as it is, as the
        reference's snapshot loader does), else one derived from the
        ids."""
        self.device = index.centroids.device
        base = None if base is None else base.to(self.device)
        if base is None:
            base_norms = None
        elif base_norms is None:
            base_norms = lists_mod.base_norms(base)
        else:
            base_norms = base_norms.to(self.device)
        self.graphs = graphs_mod.GraphCache(self.device)
        self._mutate_lock = threading.RLock()
        self._wal = None  # persist.WALWriter, attach_wal
        # how a snapshot rebuilds an HNSW quantizer from the centroids
        self.hnsw_m = int(hnsw_m)
        self.ef_construction = int(ef_construction)
        self._install(index, base, base_norms, epoch=0, live_bits=live_bits)
        if namespaces is not None:
            namespaces = torch.as_tensor(namespaces, dtype=torch.bool,
                                         device=self.device)
            nlist = index.lists.nlist
            if namespaces.ndim != 2 or namespaces.shape[1] != nlist:
                raise ValueError(
                    f"namespaces must be (n_ns, nlist={nlist}) bool "
                    f"membership, got shape {tuple(namespaces.shape)}")
        self.ns_member = namespaces
        self.config = config or EngineConfig()
        if isinstance(coarse, str):
            if coarse == "flat":
                self.coarse = coarse_mod.build_flat(index.centroids)
            elif coarse == "hnsw":
                self.coarse = coarse_mod.build_hnsw_coarse(
                    index.centroids, m=hnsw_m,
                    ef_construction=ef_construction)
            elif coarse == "tree":
                self.coarse = coarse_mod.build_tree(index.centroids)
            else:
                raise ValueError(f"unknown coarse kind {coarse!r}; want one "
                                 f"of {COARSE_KINDS}")
            self.coarse_kind = coarse
        else:
            self.coarse = coarse
            self.coarse_kind = _coarse_kind_of(coarse)
        validate_config(self.config, coarse_kind=self.coarse_kind,
                        has_base=base is not None)
        # graphs dropped by mutations that had to reallocate
        self.graphs_dropped = 0

    def _install(self, index: ivf_mod.IVFIndex, base, base_norms, *,
                 epoch: int, live_bits: torch.Tensor | None = None) -> None:
        """A snapshot over the caller's tensors, with its tombstone count,
        live-row bitmap (a buffer of the engine's, kept whether or not
        tombstones exist, so its address stays put) and a locator built on
        demand."""
        lists = index.lists
        n_tomb = int(torch.sum(lists_mod.tombstone_counts(lists)))
        self._live = lists_mod.live_filter_bits(lists)
        if live_bits is not None:
            if tuple(live_bits.shape) != tuple(self._live.shape):
                raise ValueError(
                    f"live_bits has shape {tuple(live_bits.shape)}, the "
                    f"store wants {tuple(self._live.shape)}")
            self._live.copy_(live_bits)
        self._owned = False
        self._locator: _Locator | None = None
        self._state = EngineState(
            index=index, base=base, base_norms=base_norms,
            live_bits=self._live if n_tomb else None, epoch=epoch,
            n_tombstones=n_tomb)

    # -- the current snapshot ------------------------------------------------

    @property
    def index(self) -> ivf_mod.IVFIndex:
        return self._state.index

    @index.setter
    def index(self, index: ivf_mod.IVFIndex) -> None:
        with self._mutate_lock, self.graphs.ordered():
            st = self._state
            self._install(index, st.base, st.base_norms, epoch=st.epoch + 1)

    @property
    def base(self) -> torch.Tensor | None:
        return self._state.base

    @base.setter
    def base(self, base: torch.Tensor | None) -> None:
        with self._mutate_lock, self.graphs.ordered():
            self._state = self._state._replace(base=base)
            self._owned = False

    @property
    def base_norms(self) -> torch.Tensor | None:
        return self._state.base_norms

    @base_norms.setter
    def base_norms(self, norms: torch.Tensor | None) -> None:
        with self._mutate_lock, self.graphs.ordered():
            self._state = self._state._replace(base_norms=norms)
            self._owned = False

    @property
    def live_bits(self) -> torch.Tensor | None:
        """Packed live-row bitmap; None while the store holds no
        tombstones."""
        return self._state.live_bits

    @property
    def epoch(self) -> int:
        """Mutations so far: every upsert, delete (of at least one row) and
        compact bumps it. A search started after a mutation returned sees
        at least that epoch."""
        return self._state.epoch

    @property
    def n_tombstones(self) -> int:
        """Tombstoned slots held (0 right after ``compact``)."""
        return self._state.n_tombstones

    @classmethod
    def build(cls, train_x, base_x, *, m: int, nlist: int,
              coarse="flat", config: EngineConfig | None = None,
              cap: int | None = None, coarse_iters: int = 20,
              pq_iters: int = 25, keep_base: bool = True, seed: int = 0,
              device: str | torch.device | None = None,
              **coarse_kw) -> "SearchEngine":
        """Train + bucket + wrap: raw vectors (numpy or tensors) to a live
        engine on ``device`` (None = the CUDA card; raises without one).
        k-means draws from a ``torch.Generator`` seeded with ``seed``;
        ``coarse_kw`` (``hnsw_m``, ``ef_construction``) goes to the
        constructor."""
        dev = resolve_device(device)
        train = torch.as_tensor(train_x, dtype=torch.float32, device=dev)
        base = torch.as_tensor(base_x, dtype=torch.float32, device=dev)
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            index = ivf_mod.build_ivf(train, base, m=m, nlist=nlist, cap=cap,
                                      coarse_iters=coarse_iters,
                                      pq_iters=pq_iters, generator=gen)
        return cls(index, base=base if keep_base else None, coarse=coarse,
                   config=config, **coarse_kw)

    def _queries(self, queries) -> torch.Tensor:
        q = torch.as_tensor(queries, dtype=torch.float32, device=self.device)
        return (q[None] if q.ndim == 1 else q).contiguous()

    def select_probes(self, q, nprobe: int) -> torch.Tensor:
        """Stage 1 alone: up to nprobe lists per query (-1 = none), under
        the config's probe policy (the pruned counter is dropped; call
        ``coarse_probes`` to see it)."""
        probes, _ = coarse_probes(
            self.coarse, self._queries(q), nprobe=nprobe, ef=self.config.ef,
            probe_policy=self.config.probe_policy,
            margin_tau=self.config.margin_tau)
        return probes

    def scan(self, q, probe_ids: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor]:
        """Stage 2 alone: the full candidate pool per query, (dists (Q, C)
        f32, ids (Q, C) i32) with C = P * cap, by the config's scan impl
        (``core.ivf.scan_probes``)."""
        with self.graphs.ordered():
            dists, ids, _ = scan_candidates(
                self.index, self._queries(q),
                torch.as_tensor(probe_ids, dtype=torch.int32,
                                device=self.device),
                scan_impl=self.config.scan_impl)
        return dists, ids

    def _resolve(self, queries, nprobe, rerank_mult, filter_bits, namespaces,
                 margin_tau, st: EngineState):
        q = self._queries(queries)
        nprobe = self.config.nprobe if nprobe is None else nprobe
        r = self.config.rerank_mult if rerank_mult is None else rerank_mult
        if margin_tau is not None and self.config.probe_policy != "margin":
            raise ValueError(
                "margin_tau override given but probe_policy is "
                f"{self.config.probe_policy!r}; build the engine with "
                "EngineConfig(probe_policy='margin')")
        tau = None
        if self.config.probe_policy == "margin":
            tau = self.config.margin_tau if margin_tau is None else margin_tau
            if isinstance(tau, numbers.Real):
                # filled on the device: a host copy would wait for the
                # stream's queued work
                tau = torch.full((), float(tau), dtype=torch.float32,
                                 device=self.device)
            else:
                tau = torch.as_tensor(tau, dtype=torch.float32,
                                      device=self.device)
            if tau.ndim not in (0, 1) or (tau.ndim == 1
                                          and tau.shape != (q.shape[0],)):
                raise ValueError(
                    f"margin_tau must be a scalar or ({q.shape[0]},) per-"
                    f"query widths, got shape {tuple(tau.shape)}")
        if r and st.base is None:
            raise ValueError("exact re-rank requested but engine holds no "
                             "base vectors (build with keep_base=True)")
        if filter_bits is not None:
            lists = st.index.lists
            nlist, cap = lists.nlist, lists.cap
            filter_bits = torch.as_tensor(filter_bits, device=self.device)
            if (filter_bits.ndim != 2 or filter_bits.shape[0] != nlist
                    or filter_bits.shape[1] * 8 < cap):
                raise ValueError(
                    f"filter_bits must be (nlist={nlist}, "
                    f"W>=ceil(cap/8)={filter_words(cap)}) packed u8, got "
                    f"shape {tuple(filter_bits.shape)}; a compaction or "
                    "growth may have changed cap: derive filters from the "
                    "live store")
            filter_bits = filter_bits[:, :filter_words(cap)].to(
                torch.uint8).contiguous()
        if namespaces is not None:
            if self.ns_member is None:
                raise ValueError(
                    "per-query namespaces given but the engine was built "
                    "without a namespace table (pass namespaces=(n_ns, nlist) "
                    "bool membership to SearchEngine)")
            namespaces = torch.as_tensor(namespaces, dtype=torch.int32,
                                         device=self.device)
            if namespaces.ndim == 0:
                namespaces = namespaces[None]
            if namespaces.shape != (q.shape[0],):
                raise ValueError(
                    f"namespaces must be ({q.shape[0]},) i32 (one per query, "
                    f"-1 = unrestricted), got shape "
                    f"{tuple(namespaces.shape)}")
            namespaces = namespaces.contiguous()
        return q, nprobe, r, filter_bits, namespaces, tau

    def _bind(self, *, k: int, nprobe: int, r: int,
              st: EngineState | None = None):
        """The pipeline over one snapshot of the engine's state (None = the
        current one): (fn of (q, filter_bits, namespaces, margin_tau), the
        state tensors fn reads). The live-row bitmap's presence is fixed
        here; its values are read at each call, as a graph replay reads
        them."""
        st = self._state if st is None else st
        coarse, index, base, norms = (self.coarse, st.index, st.base,
                                      st.base_norms)
        live, member, cfg = st.live_bits, self.ns_member, self.config

        def fn(q, fb, ns, tau):
            return _pipeline(coarse, index, base, norms,
                             member if ns is not None else None, q, fb, ns,
                             live, tau, k=k, nprobe=nprobe, r=r,
                             scan_impl=cfg.scan_impl,
                             rerank_impl=cfg.rerank_impl, ef=cfg.ef,
                             probe_policy=cfg.probe_policy,
                             early_exit=cfg.early_exit)
        lists = index.lists
        return fn, (lists.codes, lists.ids, lists.sizes, index.centroids,
                    index.codebook.codewords, base, norms, member, self._live,
                    *(() if self.coarse_kind == "custom"
                      else coarse.tensors()))

    def _knobs(self, k: int, nprobe: int, r: int) -> tuple:
        """The static knobs of a graph key: the request's and the config's,
        and the coarse quantizer's kind."""
        cfg = self.config
        return (k, nprobe, r, cfg.scan_impl, cfg.rerank_impl,
                cfg.probe_policy, cfg.early_exit, cfg.ef, self.coarse_kind)

    def search(self, queries, k: int = 10, *, nprobe: int | None = None,
               rerank_mult: int | None = None, filter_bits=None,
               namespaces=None, margin_tau=None) -> SearchResult:
        """Batched ANN search, eagerly. queries: (Q, D) or (D,), moved to
        the engine's device. ``rerank_mult`` overrides the config (0 = pure
        fast-scan); ``filter_bits`` is an optional (nlist, W) packed
        per-row bitmap (bit 1 = the row may appear in results);
        ``namespaces`` an optional (Q,) i32 of per-query tenant ids into
        ``ns_member``, -1 = unrestricted; ``margin_tau`` (scalar or (Q,))
        overrides the config's margin width for this request, only under
        ``probe_policy='margin'``. The whole search reads one snapshot of
        the engine, in order with its mutations."""
        with self.graphs.ordered(), torch.no_grad():
            st = self._state
            q, nprobe, r, fb, ns, tau = self._resolve(
                queries, nprobe, rerank_mult, filter_bits, namespaces,
                margin_tau, st)
            fn, _ = self._bind(k=k, nprobe=nprobe, r=r, st=st)
            return fn(q, fb, ns, tau)

    def search_jit(self, queries, k: int = 10, *, nprobe: int | None = None,
                   rerank_mult: int | None = None, filter_bits=None,
                   namespaces=None, margin_tau=None) -> SearchResult:
        """The reference's serving entry point: ``search``'s semantics and,
        bit for bit, its results, as one CUDA graph replay per batch
        (``engine.graphs``: one graph per (shape, knobs, presence of each
        optional input and of the live-row bitmap, state) key,
        ``fused_cache_size``). The values of the queries, filter,
        namespaces and tau never capture a new graph, nor do mutations
        that keep every shape. On the CPU (only when asked for), and with a
        custom coarse object (whose tensors the cache cannot key), it runs
        ``search``'s pipeline and captures nothing."""
        if self.device.type != "cuda" or self.coarse_kind == "custom":
            return self.search(queries, k, nprobe=nprobe,
                               rerank_mult=rerank_mult,
                               filter_bits=filter_bits,
                               namespaces=namespaces, margin_tau=margin_tau)
        with self.graphs.lock, torch.no_grad():
            st = self._state
            q, nprobe, r, fb, ns, tau = self._resolve(
                queries, nprobe, rerank_mult, filter_bits, namespaces,
                margin_tau, st)
            fn, state = self._bind(k=k, nprobe=nprobe, r=r, st=st)
            key = graphs_mod.graph_key(
                q, (fb, ns, tau, st.live_bits),
                knobs=self._knobs(k, nprobe, r),
                state=graphs_mod.state_identity(state))
            return self.graphs.run(key, state, fn, (q, fb, ns, tau))

    # -- live mutation --------------------------------------------------------

    def attach_wal(self, wal) -> None:
        """Attach a ``persist.WALWriter``: every later ``upsert`` /
        ``delete`` / ``compact`` appends a checksummed, fsync'd record
        before its first write, so the mutation is durable once the call
        returns. ``None`` detaches (replay must not log again)."""
        with self._mutate_lock:
            self._wal = wal

    def locate(self, gid: int) -> tuple[int, int] | None:
        """(list, slot) of a live row by global id, None if absent or
        deleted."""
        with self._mutate_lock:
            loc = self._locate()
            g = np.asarray([int(gid)], np.int64)
            if not loc.present(g)[0]:
                return None
            lists, slots = loc.find(g)
            return int(lists[0]), int(slots[0])

    def _locate(self) -> _Locator:
        # callers hold _mutate_lock; built on first use, then kept current
        if self._locator is None:
            with self.graphs.ordered():
                ids = self._state.index.lists.ids.cpu().numpy()
            self._locator = _Locator(ids)
        return self._locator

    def _live_for(self, store: lists_mod.ListStore, n_tomb: int
                  ) -> torch.Tensor | None:
        """Bring the live-row buffer up to date with ``store`` (a new buffer
        when the cap changed) and return it, or None without tombstones."""
        bits = lists_mod.live_filter_bits(store)
        if self._live.shape != bits.shape:
            self._live = bits
        elif n_tomb:
            self._live.copy_(bits)
        return self._live if n_tomb else None

    def _dropped_graphs(self) -> None:
        self.graphs_dropped += self.graphs.clear()

    def _own(self) -> EngineState:
        """The current snapshot, over tensors of the engine's own: the first
        write after the caller installed tensors clones the store, base and
        norms (a reallocation: the graphs that read the caller's tensors
        are dropped). Callers hold the mutate lock inside ``ordered``."""
        st = self._state
        if self._owned:
            return st
        lists = lists_mod.ListStore(*(None if t is None else t.clone()
                                      for t in st.index.lists))
        st = st._replace(
            index=st.index._replace(lists=lists),
            base=None if st.base is None else st.base.clone(),
            base_norms=None if st.base_norms is None
            else st.base_norms.clone())
        self._state, self._owned = st, True
        self._dropped_graphs()
        return st

    def upsert(self, ids, vecs, *, attrs=None) -> np.ndarray:
        """Insert or replace rows: encode, route, append into spare slots.

        ids: (B,) int global ids (>= 0, unique within the batch); vecs:
        (B, D) f32 (numpy or a tensor); attrs: optional (B,) i32 filter
        attributes (the store must carry an attrs column). Returns the (B,)
        i32 list each row was routed to (its nearest centroid).

        A re-upserted id is tombstoned, then appended like a new row, in one
        epoch. Codes come from ``core.ivf.encode_rows`` (batch-independent
        bit for bit). When a target list lacks spare slots the store is
        compacted and, if still short, grown to the next multiple of 8 of
        what the live rows and the batch need; verdicts keyed to the old cap
        are dropped. ``base``/``base_norms`` grow to 256-row multiples
        (re-rank verdicts keyed to the old row count are dropped) and get
        the new rows, norms by ``core.lists.base_norms``' expression. A
        write that reallocates drops the engine's graphs; the rest go in
        place. The namespace table is the caller's and is not touched.
        """
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
            raise ValueError("upsert ids must be >= 0 (-1 is the padding "
                             "sentinel)")
        if np.unique(ids).size != ids.size:
            raise ValueError("duplicate ids within one upsert batch; the "
                             "slot order would be ambiguous: dedupe to the "
                             "latest value first")
        avals = None if attrs is None else np.asarray(attrs, np.int32)
        with self._mutate_lock:
            st = self._state
            d = st.index.centroids.shape[1]
            if vecs.shape[1] != d:
                raise ValueError(f"upsert vecs have D={vecs.shape[1]}, "
                                 f"engine expects D={d}")
            if avals is not None and st.index.lists.attrs is None:
                raise ValueError("append_rows: attrs given but the store "
                                 "holds no attrs column (build with "
                                 "attrs=...)")
            assign, packed = ivf_mod.encode_rows(st.index.centroids,
                                                 st.index.codebook, vecs)
            loc = self._locate()
            if self._wal is not None:
                # durable before visible: nothing below refuses the batch
                self._wal.log_upsert(ids, vecs.cpu().numpy(), avals)
            with self.graphs.ordered():
                if self._upsert_locked(self._own(), loc, ids, vecs, assign,
                                       packed, avals):
                    self._dropped_graphs()
        return assign

    def _upsert_locked(self, st: EngineState, loc: _Locator, ids, vecs,
                       assign, packed, avals) -> bool:
        """``upsert``'s writes, under the cache's lock; True when a tensor
        was reallocated."""
        store = st.index.lists
        n_tomb = st.n_tombstones
        hit = ids[loc.present(ids)]
        if hit.size:
            lists_mod.tombstone_rows(store, *loc.find(hit))
            loc.drop(hit)
            n_tomb += hit.size
        incoming = np.bincount(assign, minlength=store.nlist)
        realloc = False
        if (store.sizes.cpu().numpy() + incoming > store.cap).any():
            # compact first; grow cap only when the live rows and the batch
            # need it (to a multiple of 8: the filter width stays exact)
            live = lists_mod.live_counts(store).cpu().numpy()
            old_cap = store.cap
            new_cap = max(old_cap, -(-int((live + incoming).max()) // 8) * 8)
            store = lists_mod.compact_lists(store, cap=new_cap)
            n_tomb = 0
            loc = self._locator = _Locator(store.ids.cpu().numpy())
            if new_cap != old_cap:
                ops_mod.clear_autotune_cache(nlist=store.nlist, cap=old_cap)
                realloc = True
        store, slots = lists_mod.append_rows(store, assign, packed,
                                             ids.astype(np.int32), avals)
        loc.put(ids, assign, slots)
        base, norms = st.base, st.base_norms
        if base is not None:
            n0 = base.shape[0]
            need = int(ids.max()) + 1
            if need > n0:
                grown = -(-need // 256) * 256
                base = torch.cat([base, base.new_zeros((grown - n0,
                                                        base.shape[1]))])
                norms = torch.cat([norms, norms.new_zeros((grown - n0,))])
                ops_mod.clear_autotune_cache(kind="rerank", n=n0)
                realloc = True
            at = (torch.as_tensor(ids, device=self.device),)
            base.index_put_(at, vecs)
            norms.index_put_(at, lists_mod.base_norms(vecs))
        self._state = EngineState(
            index=st.index._replace(lists=store), base=base,
            base_norms=norms, live_bits=self._live_for(store, n_tomb),
            epoch=st.epoch + 1, n_tombstones=n_tomb)
        return realloc

    def delete(self, ids) -> int:
        """Tombstone rows by global id; unknown or already deleted ids are
        ignored. Returns the number of rows deleted. The code bytes and the
        base row stay until ``compact``, unreachable. After this returns, no
        later search returns these ids. Writes in place: the engine's graphs
        keep serving."""
        ids = np.unique(np.asarray(
            ids.cpu() if isinstance(ids, torch.Tensor) else ids, np.int64))
        with self._mutate_lock:
            loc = self._locate()
            found = ids[loc.present(ids)]
            if not found.size:
                return 0  # logs nothing, as the reference
            if self._wal is not None:
                # the whole batch: replay finds the same rows
                self._wal.log_delete(ids)
            with self.graphs.ordered():
                st = self._own()
                store = lists_mod.tombstone_rows(st.index.lists,
                                                 *loc.find(found))
                loc.drop(found)
                n_tomb = st.n_tombstones + int(found.size)
                self._state = st._replace(
                    live_bits=self._live_for(store, n_tomb),
                    epoch=st.epoch + 1, n_tombstones=n_tomb)
            return int(found.size)

    def compact(self, cap: int | None = None) -> int:
        """Rebuild every list tombstone-free: survivors keep their slot
        order; ``cap`` may grow (headroom for upserts) or shrink to fit.
        At the same cap the lists are rewritten in place and the graphs
        keep serving; another cap reallocates, drops the graphs and the
        scan verdicts keyed to the old cap. Returns the tombstoned slots
        reclaimed."""
        with self._mutate_lock:
            if cap is not None:
                with self.graphs.ordered():
                    lists_mod.check_compact_cap(self._state.index.lists, cap)
            if self._wal is not None:
                self._wal.log_compact(cap)
            with self.graphs.ordered():
                st = self._own()
                old_cap = st.index.lists.cap
                store = lists_mod.compact_lists(st.index.lists, cap=cap)
                self._locator = _Locator(store.ids.cpu().numpy())
                self._state = EngineState(
                    index=st.index._replace(lists=store), base=st.base,
                    base_norms=st.base_norms,
                    live_bits=self._live_for(store, 0), epoch=st.epoch + 1,
                    n_tombstones=0)
                if store.cap != old_cap:
                    ops_mod.clear_autotune_cache(nlist=store.nlist,
                                                 cap=old_cap)
                    self._dropped_graphs()
            return st.n_tombstones


def _coarse_kind_of(coarse) -> str:
    if isinstance(coarse, coarse_mod.FlatCoarse):
        return "flat"
    if isinstance(coarse, coarse_mod.HNSWCoarse):
        return "hnsw"
    if isinstance(coarse, coarse_mod.TreeCoarse):
        return "tree"
    return "custom"

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

Not ported yet, and raising ``NotImplementedError`` when asked for:
mutation (upsert/delete/compact, tombstoned stores), HNSW/tree coarse.
"""
from __future__ import annotations

import numbers
from typing import NamedTuple

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
# valid-probe fraction the autotune sweep assumes under the margin policy:
# an adaptive workload's 'auto' verdict is timed (and cached) against a
# probe set with this fill instead of a dense one
MARGIN_PROBE_FILL = 0.5


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not yet ported to repro_torch (ROADMAP Queue 1 item "
        f"{item})")


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
    rows_tombstoned: torch.Tensor  # zeros: mutation is not ported
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


def coarse_probes(coarse: coarse_mod.FlatCoarse, q: torch.Tensor, *,
                  nprobe: int, ns_member: torch.Tensor | None = None,
                  namespaces: torch.Tensor | None = None,
                  probe_policy: str = "fixed",
                  margin_tau: torch.Tensor | float | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Stage 1: the nprobe nearest lists. Returns (probes (Q, nprobe) i32,
    -1 = no probe; lists_pruned (Q,) i32). Under ``probe_policy='margin'``
    a probe survives only while its centroid distance is within
    ``(1 + margin_tau) x`` the query's best (``core.topk.
    margin_prune_probes``; scalar or (Q,) tau, None or +inf keeps all).

    Namespaces: ``ns_member`` is the engine's (n_ns, nlist) bool table and
    ``namespaces`` the (Q,) i32 tenant of each query (-1 = unrestricted).
    The restriction is fused into probe selection (``masked_topk`` over the
    allowed lists), so a tenant's scan touches only its own lists; a
    tenant with fewer than nprobe lists gets -1 probes. With every query at
    -1 the result is bit for bit ``smallest_k``'s. A tenant id past the
    table reads its last row, as the reference's clamped gather does.
    """
    if ns_member is not None and namespaces is not None:
        row = torch.clamp(namespaces, 0, ns_member.shape[0] - 1).long()
        allow = (namespaces < 0)[:, None] | ns_member[row]
        vals, probes = topk_mod.masked_topk(
            pairwise_sqdist(q, coarse.centroids), allow, nprobe)
    else:
        vals, probes = coarse.search(q, nprobe)
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


def _probe_sum(probes: torch.Tensor, per_list: torch.Tensor) -> torch.Tensor:
    """Sum a (nlist,) per-list counter over each query's valid probes."""
    got = per_list[torch.clamp_min(probes, 0).long()]
    return torch.sum(torch.where(probes >= 0, got, 0), dim=1,
                     dtype=torch.int32)


def count_rows_filtered(index: ivf_mod.IVFIndex, probes: torch.Tensor,
                        filter_bits: torch.Tensor | None) -> torch.Tensor:
    """(Q,) i32: probed rows the filter excluded; zero without a filter."""
    if filter_bits is None:
        return torch.zeros((probes.shape[0],), dtype=torch.int32,
                           device=probes.device)
    excluded = index.lists.sizes - filter_pass_sizes(index.lists, filter_bits)
    return _probe_sum(probes, excluded)


def make_stats(index: ivf_mod.IVFIndex, probes: torch.Tensor,
               reranked: torch.Tensor,
               filter_bits: torch.Tensor | None = None,
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
        rows_filtered=count_rows_filtered(index, probes, filter_bits),
        rows_tombstoned=zeros,
        lists_pruned=zeros if lists_pruned is None else lists_pruned,
        tiles_skipped=zeros if tiles_skipped is None else tiles_skipped)


def _pipeline(coarse, index: ivf_mod.IVFIndex, base: torch.Tensor | None,
              norms: torch.Tensor | None, ns_member: torch.Tensor | None,
              q: torch.Tensor, filter_bits: torch.Tensor | None,
              namespaces: torch.Tensor | None,
              margin_tau: torch.Tensor | None = None, *, k: int, nprobe: int,
              r: int, scan_impl: str, rerank_impl: str,
              probe_policy: str = "fixed", early_exit: bool = False
              ) -> SearchResult:
    """The whole query path as one function (stages 1-4 + stats). A
    namespace-excluded probe is -1, so it counts in no stat."""
    probes, lists_pruned = coarse_probes(
        coarse, q, nprobe=nprobe, ns_member=ns_member, namespaces=namespaces,
        probe_policy=probe_policy, margin_tau=margin_tau)
    flat_d, flat_ids, tiles_skipped = scan_candidates(
        index, q, probes, scan_impl=scan_impl, keep=(r * k) if r else k,
        filter_bits=filter_bits, early_exit=early_exit,
        probe_fill=(MARGIN_PROBE_FILL if probe_policy == "margin" else 1.0))
    vals, out_ids, reranked = rerank_mod.finalize_candidates(
        flat_d, flat_ids, base, q, k, r, norms=norms, rerank_impl=rerank_impl)
    return SearchResult(dists=vals, ids=out_ids,
                        stats=make_stats(index, probes, reranked, filter_bits,
                                         lists_pruned, tiles_skipped))


class SearchEngine:
    """IVF + 4-bit fast-scan + exact re-rank behind one ``search(queries, k)``.

    The engine lives on the device of its index. ``base`` (the raw float
    vectors) is optional; without it re-rank requests are rejected.
    ``namespaces`` is an optional (n_ns, nlist) bool membership table, kept
    as ``ns_member``: row t = the lists holding tenant t's vectors.
    """

    def __init__(self, index: ivf_mod.IVFIndex, *,
                 base: torch.Tensor | None = None,
                 coarse: str | coarse_mod.FlatCoarse = "flat",
                 config: EngineConfig | None = None,
                 namespaces=None, base_norms: torch.Tensor | None = None):
        """``base_norms`` takes precomputed ``‖x‖²`` of the base rows (a
        carried-over index brings its own); they are derived when absent."""
        lists = index.lists
        live = torch.sum(lists.ids >= 0, dim=-1, dtype=torch.int32)
        if bool(torch.any(live != lists.sizes)):
            raise _not_ported("a store holding tombstones (mutation)", "4")
        self.device = index.centroids.device
        self.index = index
        self.base = None if base is None else base.to(self.device)
        if self.base is None:
            self.base_norms = None
        elif base_norms is None:
            self.base_norms = lists_mod.base_norms(self.base)
        else:
            self.base_norms = base_norms.to(self.device)
        if namespaces is not None:
            namespaces = torch.as_tensor(namespaces, dtype=torch.bool,
                                         device=self.device)
            if namespaces.ndim != 2 or namespaces.shape[1] != lists.nlist:
                raise ValueError(
                    f"namespaces must be (n_ns, nlist={lists.nlist}) bool "
                    f"membership, got shape {tuple(namespaces.shape)}")
        self.ns_member = namespaces
        self.config = config or EngineConfig()
        if isinstance(coarse, coarse_mod.FlatCoarse):
            self.coarse = coarse
        elif coarse == "flat":
            self.coarse = coarse_mod.build_flat(index.centroids)
        else:
            raise _not_ported(f"coarse={coarse!r}", "5")
        self.coarse_kind = "flat"
        validate_config(self.config, coarse_kind=self.coarse_kind,
                        has_base=base is not None)
        self.graphs = graphs_mod.GraphCache(self.device)

    @classmethod
    def build(cls, train_x, base_x, *, m: int, nlist: int,
              coarse: str = "flat", config: EngineConfig | None = None,
              cap: int | None = None, coarse_iters: int = 20,
              pq_iters: int = 25, keep_base: bool = True, seed: int = 0,
              device: str | torch.device | None = None) -> "SearchEngine":
        """Train + bucket + wrap: raw vectors (numpy or tensors) to a live
        engine on ``device`` (None = the CUDA card; raises without one).
        k-means draws from a ``torch.Generator`` seeded with ``seed``."""
        dev = resolve_device(device)
        train = torch.as_tensor(train_x, dtype=torch.float32, device=dev)
        base = torch.as_tensor(base_x, dtype=torch.float32, device=dev)
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            index = ivf_mod.build_ivf(train, base, m=m, nlist=nlist, cap=cap,
                                      coarse_iters=coarse_iters,
                                      pq_iters=pq_iters, generator=gen)
        return cls(index, base=base if keep_base else None, coarse=coarse,
                   config=config)

    def _queries(self, queries) -> torch.Tensor:
        q = torch.as_tensor(queries, dtype=torch.float32, device=self.device)
        return (q[None] if q.ndim == 1 else q).contiguous()

    def select_probes(self, q, nprobe: int) -> torch.Tensor:
        """Stage 1 alone: up to nprobe lists per query (-1 = none), under
        the config's probe policy (the pruned counter is dropped; call
        ``coarse_probes`` to see it)."""
        probes, _ = coarse_probes(
            self.coarse, self._queries(q), nprobe=nprobe,
            probe_policy=self.config.probe_policy,
            margin_tau=self.config.margin_tau)
        return probes

    def scan(self, q, probe_ids: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor]:
        """Stage 2 alone: the full candidate pool per query, (dists (Q, C)
        f32, ids (Q, C) i32) with C = P * cap, by the config's scan impl
        (``core.ivf.scan_probes``)."""
        dists, ids, _ = scan_candidates(
            self.index, self._queries(q),
            torch.as_tensor(probe_ids, dtype=torch.int32, device=self.device),
            scan_impl=self.config.scan_impl)
        return dists, ids

    def _resolve(self, queries, nprobe, rerank_mult, filter_bits, namespaces,
                 margin_tau):
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
        if r and self.base is None:
            raise ValueError("exact re-rank requested but engine holds no "
                             "base vectors (build with keep_base=True)")
        if filter_bits is not None:
            lists = self.index.lists
            nlist, cap = lists.nlist, lists.cap
            filter_bits = torch.as_tensor(filter_bits, device=self.device)
            if (filter_bits.ndim != 2 or filter_bits.shape[0] != nlist
                    or filter_bits.shape[1] * 8 < cap):
                raise ValueError(
                    f"filter_bits must be (nlist={nlist}, "
                    f"W>=ceil(cap/8)={filter_words(cap)}) packed u8, got "
                    f"shape {tuple(filter_bits.shape)}")
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

    def _bind(self, *, k: int, nprobe: int, r: int):
        """The pipeline over one snapshot of the engine's state: (fn of
        (q, filter_bits, namespaces, margin_tau), the state tensors fn
        reads)."""
        coarse, index, base, norms = (self.coarse, self.index, self.base,
                                      self.base_norms)
        member, cfg = self.ns_member, self.config

        def fn(q, fb, ns, tau):
            return _pipeline(coarse, index, base, norms,
                             member if ns is not None else None, q, fb, ns,
                             tau, k=k, nprobe=nprobe, r=r,
                             scan_impl=cfg.scan_impl,
                             rerank_impl=cfg.rerank_impl,
                             probe_policy=cfg.probe_policy,
                             early_exit=cfg.early_exit)
        lists = index.lists
        return fn, (lists.codes, lists.ids, lists.sizes, index.centroids,
                    index.codebook.codewords, coarse.centroids, base, norms,
                    member)

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
        ``probe_policy='margin'``."""
        q, nprobe, r, fb, ns, tau = self._resolve(queries, nprobe, rerank_mult,
                                                  filter_bits, namespaces,
                                                  margin_tau)
        fn, _ = self._bind(k=k, nprobe=nprobe, r=r)
        with torch.no_grad():
            return fn(q, fb, ns, tau)

    def search_jit(self, queries, k: int = 10, *, nprobe: int | None = None,
                   rerank_mult: int | None = None, filter_bits=None,
                   namespaces=None, margin_tau=None) -> SearchResult:
        """The reference's serving entry point: ``search``'s semantics and,
        bit for bit, its results, as one CUDA graph replay per batch
        (``engine.graphs``: one graph per (shape, knobs, presence of each
        optional input, state) key, ``fused_cache_size``). The values of
        the queries, filter, namespaces and tau never capture a new graph.
        On the CPU (only when asked for) it runs ``search``'s pipeline and
        captures nothing."""
        q, nprobe, r, fb, ns, tau = self._resolve(queries, nprobe, rerank_mult,
                                                  filter_bits, namespaces,
                                                  margin_tau)
        fn, state = self._bind(k=k, nprobe=nprobe, r=r)
        with torch.no_grad():
            if self.device.type != "cuda":
                return fn(q, fb, ns, tau)
            cfg = self.config
            key = graphs_mod.graph_key(
                q, (fb, ns, tau),
                knobs=(k, nprobe, r, cfg.scan_impl, cfg.rerank_impl,
                       cfg.probe_policy, cfg.early_exit),
                state=graphs_mod.state_identity(state))
            return self.graphs.run(key, state, fn, (q, fb, ns, tau))

    def upsert(self, *args, **kwargs):
        raise _not_ported("SearchEngine.upsert (mutation)", "4")

    def delete(self, *args, **kwargs):
        raise _not_ported("SearchEngine.delete (mutation)", "4")

    def compact(self, *args, **kwargs):
        raise _not_ported("SearchEngine.compact (mutation)", "4")

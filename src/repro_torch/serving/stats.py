"""Per-tenant serving accounting on top of the engine's ``QueryStats``
(counterpart of ``repro.serving.stats``).

The engine reports *work* per query (lists probed, codes scanned, candidates
re-ranked); the serving loop knows *who asked* and *how long they waited*.
``TenantStats`` joins the two: one aggregate record per caller id, updated
once per dispatched batch from the batch's ``QueryStats`` rows.

All counters are plain python ints/floats (updated after a single
device->host sync per batch, never per request) and the registry is
thread-safe — the serving loop mutates from its dispatch thread while
callers snapshot from theirs.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Iterable, Mapping

import numpy as np


@dataclasses.dataclass
class TenantStats:
    """Aggregate serving counters for one caller id."""

    tenant: str
    queries: int = 0            # requests completed
    batches: int = 0            # dispatches this tenant had >= 1 row in
    lists_probed: int = 0       # sum of QueryStats.lists_probed
    codes_scanned: int = 0      # sum of QueryStats.codes_scanned
    reranked: int = 0           # sum of QueryStats.reranked
    rows_filtered: int = 0      # sum of QueryStats.rows_filtered (rows the
    #                             attribute filter excluded mid-scan; 0 when
    #                             the loop serves unfiltered)
    rows_tombstoned: int = 0    # sum of QueryStats.rows_tombstoned (probed
    #                             slots holding deleted rows; 0 while the
    #                             index carries no tombstones)
    lists_pruned: int = 0       # sum of QueryStats.lists_pruned (coarse
    #                             probes the margin policy dropped; 0 under
    #                             probe_policy='fixed' — docs/anytime.md)
    tiles_skipped: int = 0      # sum of QueryStats.tiles_skipped (scan tiles
    #                             the early-exit bound proved irrelevant; 0
    #                             without early_exit)
    rejects: int = 0            # submits shed by the bounded queue
    #                             (Overloaded, docs/serving.md); these never
    #                             enqueued, so no other counter moves
    latency_sum_s: float = 0.0  # submit -> result, summed
    latency_max_s: float = 0.0

    @property
    def mean_latency_s(self) -> float:
        return self.latency_sum_s / self.queries if self.queries else 0.0

    @property
    def mean_codes_scanned(self) -> float:
        return self.codes_scanned / self.queries if self.queries else 0.0


class StatsRegistry:
    """Thread-safe map tenant id -> ``TenantStats``.

    The serving loop calls ``record_batch`` once per dispatched bucket with
    the *valid* (non-padding) rows of the batch's ``QueryStats``; padding
    rows never reach accounting.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._stats: dict[str, TenantStats] = {}

    def record_batch(self, tenants: Iterable[str], lists_probed: np.ndarray,
                     codes_scanned: np.ndarray, reranked: np.ndarray,
                     latencies_s: Iterable[float],
                     rows_filtered: np.ndarray | None = None,
                     rows_tombstoned: np.ndarray | None = None,
                     lists_pruned: np.ndarray | None = None,
                     tiles_skipped: np.ndarray | None = None) -> None:
        """Fold one batch's per-row counters into the per-tenant aggregates.

        tenants / latencies_s: one entry per *real* row of the batch, aligned
        with the stat arrays (each (Q_real,)). ``rows_filtered`` /
        ``rows_tombstoned`` / ``lists_pruned`` / ``tiles_skipped`` are
        optional (trailing, defaulted) so pre-filtering / pre-mutability /
        pre-anytime callers keep working.
        """
        with self._lock:
            seen: set[str] = set()
            for i, (tenant, lat) in enumerate(zip(tenants, latencies_s)):
                st = self._stats.get(tenant)
                if st is None:
                    st = self._stats[tenant] = TenantStats(tenant)
                st.queries += 1
                st.lists_probed += int(lists_probed[i])
                st.codes_scanned += int(codes_scanned[i])
                st.reranked += int(reranked[i])
                if rows_filtered is not None:
                    st.rows_filtered += int(rows_filtered[i])
                if rows_tombstoned is not None:
                    st.rows_tombstoned += int(rows_tombstoned[i])
                if lists_pruned is not None:
                    st.lists_pruned += int(lists_pruned[i])
                if tiles_skipped is not None:
                    st.tiles_skipped += int(tiles_skipped[i])
                st.latency_sum_s += float(lat)
                st.latency_max_s = max(st.latency_max_s, float(lat))
                if tenant not in seen:
                    st.batches += 1
                    seen.add(tenant)

    def record_reject(self, tenant: str) -> None:
        """Count one load-shed submit (``Overloaded``) against its tenant."""
        with self._lock:
            st = self._stats.get(tenant)
            if st is None:
                st = self._stats[tenant] = TenantStats(tenant)
            st.rejects += 1

    def snapshot(self) -> Mapping[str, TenantStats]:
        """Point-in-time copy of every tenant's aggregates."""
        with self._lock:
            return {t: dataclasses.replace(s) for t, s in self._stats.items()}

    def get(self, tenant: str) -> TenantStats:
        with self._lock:
            st = self._stats.get(tenant)
            return dataclasses.replace(st) if st is not None else TenantStats(tenant)

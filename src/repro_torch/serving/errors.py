"""Typed serving failures: overload shedding, deadlines, shutdown
(counterpart of ``repro.serving.errors``).

All subclass ``RuntimeError`` so pre-existing callers catching broadly
keep working; new callers branch on the specific type (docs/serving.md,
ops runbook). These are *expected* degraded-mode signals, not bugs: a
bounded queue must refuse work somewhere, and a typed refusal at submit
beats an unbounded queue falling over later.
"""
from __future__ import annotations


class Overloaded(RuntimeError):
    """The batcher's bounded queue (``max_pending``) is full — the request
    was shed at submit time, costing the caller nothing but this error.
    Counted in ``LoopMetrics.rejects`` and per-tenant ``TenantStats.rejects``."""


class DeadlineExceeded(RuntimeError):
    """The request's deadline expired while it was still queued; it was
    failed before burning a batch slot (it never reached ``search_jit``).
    Counted in ``LoopMetrics.deadline_misses``."""


class LoopClosed(RuntimeError):
    """The serving loop (or its batcher) is shut down: submits are refused
    and ``close()`` fails still-pending futures with this instead of
    leaving callers blocked forever."""


class NotPrimary(RuntimeError):
    """A mutation reached a standby loop: standbys replay the primary's
    shipped WAL and serve READS only — accepting a local write would fork
    the replicated history. The caller should route the write to the
    primary (or promote this standby first — docs/serving.md failover
    runbook). Queries keep working throughout."""

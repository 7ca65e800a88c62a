"""Typed failure modes of the durable-index subsystem (counterpart of
``repro.persist.errors``; the reference's docs/persistence.md).

The recovery contract is *prefix-or-loud*: opening a directory either yields
an engine bit-identical to the never-crashed engine over some prefix of the
acknowledged mutations, or raises one of these — never a silently wrong
index. Checksums turn every byte-level fault (bit flip, short read, torn
segment) into one of the typed errors below; the only faults that do NOT
raise are the ones that by construction lose nothing but an unacknowledged
tail (a torn final WAL record, a crash before the manifest rename).
"""
from __future__ import annotations


class PersistError(RuntimeError):
    """Base class of every durable-index failure."""


class NoSnapshotError(PersistError):
    """The directory holds no manifest — nothing was ever checkpointed
    there (or the manifest itself was deleted). Distinct from corruption so
    boot logic can branch on fresh-dir vs damaged-dir."""


class CorruptSnapshotError(PersistError):
    """A manifest-named segment is missing, truncated, or fails its CRC —
    the snapshot cannot be trusted and is refused wholesale."""


class CorruptWALError(PersistError):
    """A write-ahead-log record that *should* be intact is not: bad magic,
    a failed header/payload CRC with the full record present, a torn record
    that is not the final one, or a sequence gap (a missing WAL file).
    A torn tail on the FINAL file is not an error — it is the expected
    signature of a crash mid-append and recovery keeps the valid prefix."""


class FencedError(PersistError):
    """A write from a superseded term was rejected: the cluster promoted a
    new primary (its term is higher than the writer's), so the old primary
    must stop appending and shipping IMMEDIATELY. This is the split-brain
    guard of docs/persistence.md — the fenced process keeps its local
    state (useful for forensics) but no byte of it reaches the replication
    stream or the shared term authority again."""


class ReplicationError(PersistError):
    """The shipped-WAL chain cannot be followed safely: a gap in the
    shipped sequence (a dropped segment), a transport that kept failing
    past the bounded retry budget, or an undecodable ship frame. The
    standby must stop replaying and resync from a snapshot rather than
    serve a silently diverged index."""

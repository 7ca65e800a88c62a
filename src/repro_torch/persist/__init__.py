"""Crash-safe durable index: checksummed snapshots + WAL recovery
(counterpart of ``repro.persist``; the reference's docs/persistence.md).

``save_snapshot``/``load_snapshot`` serialize an engine (single-host or
sharded) as versioned, per-segment CRC-verified files behind an atomically
renamed manifest; ``WALWriter`` (attached via ``engine.attach_wal``) makes
every mutation durable before it becomes visible; ``open_engine`` recovers
snapshot + replay on the card (or on ``device='cpu'`` when asked),
bit-identical to the never-crashed engine over the acknowledged prefix —
or fails loudly with a typed error. The on-disk formats are the
reference's: a directory, WAL or shipped segment written by either package
opens in the other.

The replication tier (``repro_torch.persist.replicate``) ships the same
WAL to warm standbys: ``WALShipper`` publishes closed segments over a
pluggable transport, ``StandbyReplica`` replays them into a read-serving
follower, and fenced failover (``promote`` + term tokens) makes
split-brain structurally impossible (``FencedError`` /
``ReplicationError``).
"""
from repro_torch.persist.errors import (CorruptSnapshotError,
                                        CorruptWALError, FencedError,
                                        NoSnapshotError, PersistError,
                                        ReplicationError)
from repro_torch.persist.replicate import (DirTransport, PipeTransport,
                                           ReplicationLag, StandbyReplica,
                                           WALShipper, decode_ship_frame,
                                           encode_ship_frame,
                                           make_fence_guard, parse_ship_name,
                                           ship_segment_name)
from repro_torch.persist.snapshot import (MANIFEST_NAME, RecoveryInfo,
                                          ensure_attached, load_snapshot,
                                          open_engine, read_manifest,
                                          save_snapshot)
from repro_torch.persist.wal import (WALRecord, WALWriter, apply_record,
                                     iter_wal, scan_wal, scan_wal_bytes,
                                     wal_files, wal_name, wal_term)

__all__ = [
    "PersistError", "NoSnapshotError", "CorruptSnapshotError",
    "CorruptWALError", "FencedError", "ReplicationError", "MANIFEST_NAME",
    "RecoveryInfo", "save_snapshot", "load_snapshot", "open_engine",
    "read_manifest", "ensure_attached", "WALRecord", "WALWriter",
    "apply_record", "iter_wal", "scan_wal", "scan_wal_bytes", "wal_files",
    "wal_name", "wal_term", "DirTransport", "PipeTransport", "WALShipper",
    "StandbyReplica", "ReplicationLag", "encode_ship_frame",
    "decode_ship_frame", "make_fence_guard", "ship_segment_name",
    "parse_ship_name",
]

"""Write-ahead mutation log: fixed-format, checksummed, fsync'd records
(counterpart of ``repro.persist.wal``, byte for byte its format: a log
written by either package replays in the other).

Every mutation (``upsert`` / ``delete`` / ``compact``) appends ONE record —
fsync'd *before* the engine installs the new in-memory epoch — so recovery
is always "last snapshot + replay" and a crash can lose at most the
unacknowledged tail (docs/persistence.md).

On-disk record format (little-endian, 28-byte preamble + payload):

    u32  magic       0x4C415752 ("RWAL")
    u8   op          1=upsert 2=delete 3=compact
    u8   flags       0 (reserved)
    u16  reserved    0
    u64  seq         global record number, contiguous from 1
    u32  payload_len
    u32  payload_crc CRC-32 of the payload bytes
    u32  header_crc  CRC-32 of the preceding 24 header bytes
    ...  payload     ``np.savez`` archive of the mutation's arrays

Torn-tail vs corruption: a record cut short by EOF (crash mid-append) is a
*clean* stop — ``scan_wal`` returns the valid prefix and flags the tail.
A record whose bytes are all present but whose CRC fails (bit flip), whose
magic is wrong, or that is torn with more data after it, raises
``CorruptWALError``: acknowledged mutations may be missing and silently
replaying the rest would build a wrong index.

WAL files are named ``wal-<start_seq:012d>.log`` so a directory's files
chain in seq order; ``rotate`` (the checkpoint path) closes the current
file and opens the next, and GC deletes files whose records a durable
snapshot fully covers.

Since the replication tier (docs/persistence.md, ``persist.replicate``)
every NEW WAL file opens with a 24-byte file header carrying the writer's
**term** — the fencing token a promotion bumps — and the file's start seq,
so a shipped or recovered segment always knows which leadership era wrote
it. Headerless files (pre-replication format) still parse; they read as
term 0.
"""
from __future__ import annotations

import io as _io
import os
import re
import struct
import threading
import time
from typing import Callable, Iterator, NamedTuple

import numpy as np

from repro_torch.persist import io as pio
from repro_torch.persist.errors import CorruptWALError

_MAGIC = 0x4C415752  # "RWAL" little-endian
_HEADER = struct.Struct("<IBBHQII")   # magic, op, flags, reserved, seq, len, crc
_HEADER_CRC = struct.Struct("<I")
PREAMBLE = _HEADER.size + _HEADER_CRC.size  # 28 bytes

_FILE_MAGIC = 0x484C5752  # "RWLH" little-endian — per-file header, not a record
_FILE_HEADER = struct.Struct("<IQQI")  # magic, term, start_seq, crc of first 20
FILE_HEADER_SIZE = _FILE_HEADER.size   # 24 bytes

OP_UPSERT = 1
OP_DELETE = 2
OP_COMPACT = 3
_OP_NAMES = {OP_UPSERT: "upsert", OP_DELETE: "delete", OP_COMPACT: "compact"}
_OP_CODES = {v: k for k, v in _OP_NAMES.items()}

_WAL_RE = re.compile(r"^wal-(\d{12})\.log$")


def wal_name(start_seq: int) -> str:
    """File name of the WAL segment whose first record is ``start_seq``."""
    return f"wal-{start_seq:012d}.log"


def wal_files(directory: str) -> list[tuple[int, str]]:
    """(start_seq, path) of every WAL file in ``directory``, seq-ascending."""
    out = []
    for name in os.listdir(directory):
        m = _WAL_RE.match(name)
        if m:
            out.append((int(m.group(1)), os.path.join(directory, name)))
    out.sort()
    return out


class WALRecord(NamedTuple):
    seq: int
    op: str                        # 'upsert' | 'delete' | 'compact'
    arrays: dict[str, np.ndarray]  # the mutation's payload arrays


def encode_file_header(term: int, start_seq: int) -> bytes:
    """24-byte per-file header: term + start seq, self-CRC'd."""
    head = _FILE_HEADER.pack(_FILE_MAGIC, int(term), int(start_seq), 0)[:20]
    return head + struct.pack("<I", pio.crc32(head))


def read_file_header(data: bytes) -> tuple[int, int] | None:
    """(term, start_seq) if ``data`` opens with a complete, valid file
    header; None for the pre-replication headerless format (or for data
    shorter than a header — a crash between header write and first append
    leaves such a prefix, which the record scan then reports as an empty
    torn file). A COMPLETE header whose CRC fails is a bit flip, not a
    tear, and raises ``CorruptWALError``."""
    if len(data) < FILE_HEADER_SIZE:
        return None
    magic, term, start_seq, crc = _FILE_HEADER.unpack(
        data[:FILE_HEADER_SIZE])
    if magic != _FILE_MAGIC:
        return None
    if crc != pio.crc32(data[:20]):
        raise CorruptWALError("WAL file header failed its CRC check")
    return int(term), int(start_seq)


def wal_term(path: str) -> int:
    """Term recorded in the file's header (0 for headerless legacy files)."""
    with open(path, "rb") as f:
        head = f.read(FILE_HEADER_SIZE)
    if len(head) < FILE_HEADER_SIZE:
        return 0
    try:
        parsed = read_file_header(head)
    except CorruptWALError:
        return 0
    return 0 if parsed is None else parsed[0]


def encode_record(seq: int, op: str, arrays: dict[str, np.ndarray]) -> bytes:
    """One record's bytes: checksummed preamble + npz payload."""
    bio = _io.BytesIO()
    np.savez(bio, **arrays)
    payload = bio.getvalue()
    head = _HEADER.pack(_MAGIC, _OP_CODES[op], 0, 0, int(seq), len(payload),
                        pio.crc32(payload))
    return head + _HEADER_CRC.pack(pio.crc32(head)) + payload


def _decode_payload(payload: bytes) -> dict[str, np.ndarray]:
    with np.load(_io.BytesIO(payload), allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def scan_wal(path: str) -> tuple[list[WALRecord], int, bool]:
    """Parse one WAL file: (records, valid_byte_length, clean).

    ``clean=False`` means the file ends in a torn record (crash mid-append):
    the returned records are the trustworthy prefix and ``valid_byte_length``
    is where it ends — the caller may truncate there before appending.
    Anything that is NOT a clean torn tail — bad magic, failed header or
    payload CRC on fully-present bytes — raises ``CorruptWALError``.
    """
    return scan_wal_bytes(pio.read_bytes(path), origin=path)


def scan_wal_bytes(data: bytes, origin: str = "<bytes>"
                   ) -> tuple[list[WALRecord], int, bool]:
    """``scan_wal`` over in-memory segment bytes (the shipped-segment path:
    a standby verifies and replays segments it never writes to disk). A
    leading file header, if present, is CRC-checked and skipped."""
    records: list[WALRecord] = []
    off = 0
    n = len(data)
    try:
        header = read_file_header(data)
    except CorruptWALError as e:
        raise CorruptWALError(f"{origin}: {e}") from None
    if header is not None:
        off = FILE_HEADER_SIZE
    path = origin
    while off < n:
        if n - off < PREAMBLE:
            return records, off, False          # torn header at EOF
        head = data[off:off + _HEADER.size]
        (magic, op_code, _flags, _rsvd, seq, plen,
         pcrc) = _HEADER.unpack(head)
        (hcrc,) = _HEADER_CRC.unpack(
            data[off + _HEADER.size:off + PREAMBLE])
        if hcrc != pio.crc32(head):
            raise CorruptWALError(
                f"{path}: header CRC mismatch at offset {off}")
        if magic != _MAGIC or op_code not in _OP_NAMES:
            raise CorruptWALError(
                f"{path}: bad record magic/op at offset {off}")
        if n - off - PREAMBLE < plen:
            return records, off, False          # torn payload at EOF
        payload = data[off + PREAMBLE:off + PREAMBLE + plen]
        if pio.crc32(payload) != pcrc:
            raise CorruptWALError(
                f"{path}: payload CRC mismatch at offset {off} (seq {seq})")
        try:
            arrays = _decode_payload(payload)
        except Exception as e:  # zipfile/np.load damage the CRC missed
            raise CorruptWALError(
                f"{path}: undecodable payload at offset {off}: {e}") from e
        records.append(WALRecord(int(seq), _OP_NAMES[op_code], arrays))
        off += PREAMBLE + plen
    return records, off, True


def iter_wal(directory: str, after_seq: int = 0) -> Iterator[WALRecord]:
    """Replay-ordered records with seq > ``after_seq`` across the file chain.

    Enforces the recovery contract: records must be contiguous from
    ``after_seq + 1`` (a gap means a missing WAL file — acknowledged
    mutations lost in the *middle*, so ``CorruptWALError``), and only the
    FINAL file may end torn (a torn earlier file likewise hides
    acknowledged mutations that later files prove existed).
    """
    files = wal_files(directory)
    expect = int(after_seq) + 1
    for i, (_start, path) in enumerate(files):
        records, _valid, clean = scan_wal(path)
        if not clean and i != len(files) - 1:
            raise CorruptWALError(
                f"{path}: torn record in a non-final WAL file")
        for rec in records:
            if rec.seq <= after_seq:
                continue
            if rec.seq != expect:
                raise CorruptWALError(
                    f"{path}: sequence gap — expected seq {expect}, found "
                    f"{rec.seq} (a WAL file is missing or out of order)")
            yield rec
            expect += 1


class WALWriter:
    """Append-side of the log: one open file, fsync per record.

    Thread-safe (the engines call ``log_*`` under their own mutation lock,
    but the checkpointer rotates from another thread). ``seq`` is global
    and survives rotation — the next record after ``rotate`` lands in the
    new file with the next contiguous number.

    ``term`` is the fencing token of docs/persistence.md: it is stamped
    into every file header this writer creates, and an optional ``guard``
    callable runs before every append — the replication tier installs one
    that raises ``FencedError`` once a newer term exists, so a deposed
    primary cannot extend its log even by one record.

    ``fsync_interval`` enables **group commit**: appends write to the OS
    immediately but the fsync is deferred until the interval elapses (or
    an explicit ``flush``/``rotate``/``close``). Throughput per mutation
    burst rises by the batched-fsync factor; the durability point of an
    individual record widens to at most one interval — choose per
    deployment (docs/persistence.md#group-commit).
    """

    def __init__(self, path: str, next_seq: int, *, term: int = 0,
                 fsync_interval: float | None = None,
                 guard: Callable[[], None] | None = None):
        self.path = path
        self.term = int(term)
        self.guard = guard
        if fsync_interval is not None and fsync_interval < 0:
            raise ValueError(
                f"fsync_interval must be >= 0, got {fsync_interval}")
        self.fsync_interval = fsync_interval
        self._f = open(path, "ab")
        self._next = int(next_seq)
        self._written_here = 0  # records appended to the CURRENT file
        self._pending_fsync = 0  # group-commit records not yet fsync'd
        self._last_fsync = time.monotonic()
        self._lock = threading.Lock()
        self._write_header_if_new()

    def _write_header_if_new(self) -> None:
        # a brand-new file opens with the term header; a reopened file
        # (recovery attaching at an existing path) keeps whatever it has
        self._f.seek(0, os.SEEK_END)
        if self._f.tell() == 0:
            pio.append_record(self._f, encode_file_header(self.term,
                                                          self._next))

    @property
    def last_seq(self) -> int:
        """Seq of the last appended record (0 before the first)."""
        with self._lock:
            return self._next - 1

    def append(self, op: str, arrays: dict[str, np.ndarray]) -> int:
        """Encode + append one record; returns its seq.

        Without ``fsync_interval`` the record is fsync'd before this
        returns (the classic acknowledge point). With it, the fsync may be
        deferred up to one interval (group commit). Either way the bytes
        are written in seq order, so a crash still tears only the tail.
        """
        with self._lock:
            if self.guard is not None:
                self.guard()
            seq = self._next
            data = encode_record(seq, op, arrays)
            if self.fsync_interval is None:
                pio.append_record(self._f, data)
            else:
                pio.append_bytes(self._f, data)
                self._pending_fsync += 1
                now = time.monotonic()
                if now - self._last_fsync >= self.fsync_interval:
                    pio.fsync_file(self._f)
                    self._pending_fsync = 0
                    self._last_fsync = now
            self._next += 1
            self._written_here += 1
            return seq

    def flush(self) -> None:
        """Force the group-commit tail to disk (no-op when nothing is
        pending or every append already fsync'd). After this returns every
        appended record survives kill-9."""
        with self._lock:
            self._flush_locked()

    def _flush_locked(self) -> None:
        if self._pending_fsync and not self._f.closed:
            pio.fsync_file(self._f)
            self._pending_fsync = 0
            self._last_fsync = time.monotonic()

    # -- the engine-facing hooks (docs/persistence.md) ----------------------

    def log_upsert(self, ids: np.ndarray, vecs: np.ndarray,
                   attrs: np.ndarray | None = None) -> int:
        arrays = {"ids": np.asarray(ids, np.int64),
                  "vecs": np.asarray(vecs, np.float32)}
        if attrs is not None:
            arrays["attrs"] = np.asarray(attrs, np.int32)
        return self.append("upsert", arrays)

    def log_delete(self, ids: np.ndarray) -> int:
        return self.append("delete", {"ids": np.asarray(ids, np.int64)})

    def log_compact(self, cap: int | None) -> int:
        return self.append(
            "compact", {"cap": np.asarray(-1 if cap is None else cap,
                                          np.int64)})

    # -- checkpoint-side ----------------------------------------------------

    def rotate(self, directory: str) -> str:
        """Close the current file and start ``wal-<next_seq>.log``.

        No-op when the current file holds no records yet (back-to-back
        checkpoints with no intervening mutations would otherwise mint a
        same-named file). Flushes any group-commit tail first — a closed
        (shippable) segment is always fully durable. Returns the active
        path.
        """
        with self._lock:
            if self._written_here == 0:
                return self.path
            self._flush_locked()
            self._f.close()
            self.path = os.path.join(directory, wal_name(self._next))
            self._f = open(self.path, "ab")
            self._written_here = 0
            self._write_header_if_new()
            pio.fsync_dir(directory)
            return self.path

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._flush_locked()
                self._f.close()


def apply_record(engine, rec: WALRecord) -> None:
    """Apply one replayed record through the engine's own mutators.

    The mutators are deterministic functions of (state, arguments) — the
    exactness spine of docs/mutability.md — so replaying the logged
    arguments reproduces bit-identical state. The caller must have the
    engine's WAL detached (or never attached): replay must not re-log.
    """
    a = rec.arrays
    if rec.op == "upsert":
        engine.upsert(a["ids"], a["vecs"], attrs=a.get("attrs"))
    elif rec.op == "delete":
        engine.delete(a["ids"])
    elif rec.op == "compact":
        cap = int(a["cap"])
        engine.compact(cap=None if cap < 0 else cap)
    else:  # pragma: no cover - scan_wal already rejects unknown ops
        raise CorruptWALError(f"unknown WAL op {rec.op!r}")

"""Replication tier: WAL shipping, warm standbys, fenced failover
(counterpart of ``repro.persist.replicate``; the same frames, segment
names and TERM file, so either package's primary ships to the other's
standby).

Layered directly on the durable-index contract (docs/persistence.md): the
primary's WAL is already a totally-ordered, checksummed, prefix-or-loud
record of every acknowledged mutation, so replication is *shipping that
log* — no second serialization format, no divergent code path.

    primary                     transport                  standby
    -------                     ---------                  -------
    WALShipper.ship_once  --->  publish(seg)   --->  StandbyReplica.poll_once
      rotate + read closed        fenced by TERM         verify frame CRC
      wal-*.log segments,         (atomic files or       scan_wal_bytes,
      wrap in ship frames         in-process pipe)       apply_record past
                                                         applied_seq

**Fencing** makes split-brain structurally impossible: the transport holds
a monotonically increasing *term* — the leadership token. Every shipped
frame and every WAL file header carries the term it was written under;
``promote()`` bumps the transport term atomically, and from that instant
the old primary's next append (via the writer ``guard``) or ship (via the
``read_term`` check and the transport's own publish-side check) raises
``FencedError``. Those checks are best-effort (check-then-act), so a
deposed primary's in-flight publish can still *land* — which is why the
stream is also fenced structurally: segment names are **term-scoped**
(``t<term>-wal-<seq>.log``), so a stale publish can never overwrite or
sort after a newer term's segment, and the transport keeps a **term
chart** — for every term ever promoted, the first sequence number of its
chain. A record from term ``t`` at seq ``s`` is a fenced leftover exactly
when some newer term's chain starts at or before ``s``; standbys skip
such records (counting them in ``records_stale``) instead of replaying
them, so even a publish that slips past the fence is inert.

**Lag** is tracked in both units that matter operationally: sequence
numbers behind the primary's last heartbeat, and seconds since that
heartbeat was minted (``ReplicationLag``).

Failure handling is *bounded-retry, then loud*: transient transport
errors are retried with exponential backoff inside a per-segment time
budget; a gap in the shipped chain, an undecodable frame, or a torn
shipped segment raises ``ReplicationError`` — a standby must resync from
a snapshot rather than serve a silently diverged index.
"""
from __future__ import annotations

import json
import os
import re
import struct
import threading
import time
from typing import Callable, NamedTuple

from repro_torch.persist import io as pio
from repro_torch.persist import wal as wal_mod
from repro_torch.persist.errors import FencedError, ReplicationError

_SHIP_MAGIC = 0x50485352  # "RSHP" little-endian
_SHIP_HEADER = struct.Struct("<IQQII")  # magic, term, start_seq, len, crc
SHIP_HEADER_SIZE = _SHIP_HEADER.size + 4  # + u32 header CRC = 32 bytes

_SEG_PREFIX = "seg-"
_TERM_NAME = "TERM"
_SHIP_NAME_RE = re.compile(r"^t(\d{12})-(.+)$")


def ship_segment_name(term: int, wal_name: str) -> str:
    """Term-scoped transport name for one WAL segment.

    The zero-padded term prefix makes the published namespace term-scoped:
    lexicographic order is exactly (term, seq) replay order, and a deposed
    primary's late publish can never collide with — or sort after — a
    segment the new term published, no matter how the publish-side fence
    races.
    """
    return f"t{int(term):012d}-{wal_name}"


def parse_ship_name(name: str) -> tuple[int | None, str]:
    """(term, wal_name) from a published segment name; term is None for a
    legacy un-prefixed name (the frame header stays authoritative — the
    name's term is for namespacing and ordering only)."""
    m = _SHIP_NAME_RE.match(name)
    if m is None:
        return None, name
    return int(m.group(1)), m.group(2)


def _stale_record(chart: list[tuple[int, int]], term: int, seq: int) -> bool:
    """True when the term chart proves ``(term, seq)`` is a fenced
    primary's leftover: some newer term's chain starts at or before
    ``seq``, i.e. that suffix of history was rewritten under new
    leadership and this record can never be part of the acked prefix."""
    for t, start_seq in chart:
        if t > term and seq >= start_seq:
            return True
    return False


def encode_ship_frame(term: int, start_seq: int, payload: bytes) -> bytes:
    """Wrap one WAL segment's raw bytes for transport.

    The frame CRCs both its header and the payload, so a dropped byte in
    flight is loud at the standby before any record is parsed — the WAL's
    own per-record checksums then guard the contents a second time.
    """
    head = _SHIP_HEADER.pack(_SHIP_MAGIC, int(term), int(start_seq),
                             len(payload), pio.crc32(payload))
    return head + struct.pack("<I", pio.crc32(head)) + payload


def decode_ship_frame(data: bytes, origin: str = "<frame>"
                      ) -> tuple[int, int, bytes]:
    """(term, start_seq, payload) or ``ReplicationError`` — never a torn
    or bit-flipped frame silently accepted."""
    if len(data) < SHIP_HEADER_SIZE:
        raise ReplicationError(
            f"{origin}: ship frame truncated ({len(data)} bytes)")
    head = data[:_SHIP_HEADER.size]
    magic, term, start_seq, plen, pcrc = _SHIP_HEADER.unpack(head)
    (hcrc,) = struct.unpack(
        "<I", data[_SHIP_HEADER.size:SHIP_HEADER_SIZE])
    if magic != _SHIP_MAGIC:
        raise ReplicationError(f"{origin}: bad ship-frame magic")
    if hcrc != pio.crc32(head):
        raise ReplicationError(f"{origin}: ship-frame header CRC mismatch")
    payload = data[SHIP_HEADER_SIZE:]
    if len(payload) != plen:
        raise ReplicationError(
            f"{origin}: ship-frame payload truncated "
            f"({len(payload)} of {plen} bytes)")
    if pio.crc32(payload) != pcrc:
        raise ReplicationError(f"{origin}: ship-frame payload CRC mismatch")
    return int(term), int(start_seq), payload


# ---------------------------------------------------------------------------
# transports
# ---------------------------------------------------------------------------

class DirTransport:
    """Directory-backed transport: segments, term, and heartbeats as files.

    Every byte crosses ``persist.io`` primitives, so the fault-injection
    harness reaches shipped segments exactly like local ones; segment and
    term writes are atomic-rename publishes, so a reader never sees a torn
    file under its real name. Works across processes sharing a filesystem
    (the crash-drill and CI path) as well as across threads.
    """

    def __init__(self, directory: str):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)

    # -- term authority -----------------------------------------------------

    def _read_term_doc(self) -> dict:
        try:
            raw = pio.read_bytes(os.path.join(self.directory, _TERM_NAME))
        except FileNotFoundError:
            return {"term": 0, "chart": []}
        try:
            doc = json.loads(raw.decode("ascii"))
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise ReplicationError(f"unreadable TERM file: {e}") from e
        if isinstance(doc, int):  # legacy bare-int TERM file
            return {"term": doc, "chart": []}
        return doc

    def read_term(self) -> int:
        return int(self._read_term_doc()["term"])

    def term_chart(self) -> list[tuple[int, int]]:
        """(term, start_seq) for every promoted term, ascending — the
        authoritative record of where each leadership era's chain begins
        (term 0, the genesis era, has no entry)."""
        return sorted((int(t), int(s))
                      for t, s in self._read_term_doc()["chart"])

    def bump_term(self, new_term: int, *, start_seq: int) -> int:
        """Install a strictly higher term whose chain starts at
        ``start_seq``; ``FencedError`` otherwise — a promotion racing a
        newer promotion must lose loudly."""
        doc = self._read_term_doc()
        current = int(doc["term"])
        if new_term <= current:
            raise FencedError(
                f"term {new_term} is not newer than current {current}")
        doc["term"] = int(new_term)
        doc["chart"] = sorted(
            [[int(t), int(s)] for t, s in doc["chart"]]
            + [[int(new_term), int(start_seq)]])
        pio.atomic_write_bytes(os.path.join(self.directory, _TERM_NAME),
                               json.dumps(doc).encode("ascii"))
        return int(new_term)

    # -- segments -----------------------------------------------------------

    def publish(self, name: str, data: bytes, *, term: int) -> None:
        """Atomically publish one framed segment; the transport itself
        rejects stale-term publishes so even a shipper that skipped its
        ``read_term`` check cannot extend the stream after a promotion."""
        if term < self.read_term():
            raise FencedError(
                f"publish from term {term} rejected: transport term is "
                f"{self.read_term()}")
        pio.atomic_write_bytes(
            os.path.join(self.directory, _SEG_PREFIX + name), data)

    def list_segments(self) -> list[str]:
        """Published segments only: a publish's temp file (``<name>.tmp.
        <pid>``, renamed away once written) is not a segment, and a
        standby that listed one would find it gone when it fetched it."""
        out = [n[len(_SEG_PREFIX):] for n in os.listdir(self.directory)
               if n.startswith(_SEG_PREFIX) and ".tmp." not in n]
        out.sort()  # wal-<seq:012d>.log names sort in seq order
        return out

    def fetch(self, name: str) -> bytes:
        try:
            return pio.read_bytes(
                os.path.join(self.directory, _SEG_PREFIX + name))
        except OSError as e:
            raise ReplicationError(f"segment {name} unfetchable: {e}") from e

    # -- heartbeats ---------------------------------------------------------

    def write_heartbeat(self, role: str, info: dict) -> None:
        pio.atomic_write_bytes(
            os.path.join(self.directory, f"HEARTBEAT-{role}.json"),
            json.dumps(info).encode("utf-8"))

    def read_heartbeat(self, role: str) -> dict | None:
        try:
            data = pio.read_bytes(
                os.path.join(self.directory, f"HEARTBEAT-{role}.json"))
            return json.loads(data.decode("utf-8"))
        except (OSError, UnicodeDecodeError, json.JSONDecodeError):
            return None  # absent or mid-damage heartbeat = no signal


class PipeTransport:
    """In-process transport for the threaded harness: one shared object,
    segments and term under a lock. Same duck type as ``DirTransport``;
    tests wrap ``publish``/``fetch`` to inject drops, duplicates, and
    transient failures without touching a filesystem."""

    def __init__(self):
        self._lock = threading.Lock()
        self._segments: dict[str, bytes] = {}
        self._term = 0
        self._chart: list[tuple[int, int]] = []
        self._heartbeats: dict[str, dict] = {}

    def read_term(self) -> int:
        with self._lock:
            return self._term

    def term_chart(self) -> list[tuple[int, int]]:
        with self._lock:
            return sorted(self._chart)

    def bump_term(self, new_term: int, *, start_seq: int) -> int:
        with self._lock:
            if new_term <= self._term:
                raise FencedError(
                    f"term {new_term} is not newer than current {self._term}")
            self._term = int(new_term)
            self._chart.append((int(new_term), int(start_seq)))
            return self._term

    def publish(self, name: str, data: bytes, *, term: int) -> None:
        with self._lock:
            if term < self._term:
                raise FencedError(
                    f"publish from term {term} rejected: transport term "
                    f"is {self._term}")
            self._segments[name] = bytes(data)

    def list_segments(self) -> list[str]:
        with self._lock:
            return sorted(self._segments)

    def fetch(self, name: str) -> bytes:
        with self._lock:
            try:
                return self._segments[name]
            except KeyError:
                raise ReplicationError(
                    f"segment {name} not in transport") from None

    def write_heartbeat(self, role: str, info: dict) -> None:
        with self._lock:
            self._heartbeats[role] = dict(info)

    def read_heartbeat(self, role: str) -> dict | None:
        with self._lock:
            hb = self._heartbeats.get(role)
            return None if hb is None else dict(hb)


def make_fence_guard(transport, term: int) -> Callable[[], None]:
    """A ``WALWriter`` guard: raise ``FencedError`` the moment the
    transport knows a term newer than ``term`` — the deposed primary
    cannot extend its local log past the promotion point, so no
    acknowledged-but-unshippable suffix can ever exist."""
    def guard() -> None:
        current = transport.read_term()
        if current > term:
            raise FencedError(
                f"append from term {term} rejected: a newer primary holds "
                f"term {current}")
    return guard


# ---------------------------------------------------------------------------
# primary side: the shipper
# ---------------------------------------------------------------------------

class WALShipper:
    """Streams the primary's closed WAL segments through a transport.

    ``ship_once`` is the whole protocol: check the fence, rotate the live
    WAL file (so the records accumulated since the last ship become a
    closed, fully-fsync'd segment), then publish every not-yet-shipped
    closed segment in seq order, each wrapped in a checksummed ship frame
    stamped with this shipper's term.

    Transient transport failures are retried with exponential backoff —
    at most ``max_retries`` extra attempts per segment AND within
    ``send_timeout_s`` wall-clock per segment; past either budget,
    ``ReplicationError``. ``FencedError`` is never retried: a newer term
    exists and this primary is done.

    Idempotent across restarts: WAL files already published under THIS
    term (from ``transport.list_segments``) are skipped, and a
    re-published segment carries byte-identical records anyway (closed
    WAL files never change). Another term's publishes don't count — a
    same-named WAL file from a different leadership era is a different
    chain (the term-scoped namespace keeps them apart).
    """

    def __init__(self, engine, directory: str, transport, *, term: int = 0,
                 max_retries: int = 4, backoff_s: float = 0.01,
                 send_timeout_s: float | None = None):
        self.engine = engine
        self.directory = directory
        self.transport = transport
        self.term = int(term)
        self.max_retries = int(max_retries)
        self.backoff_s = float(backoff_s)
        self.send_timeout_s = send_timeout_s
        self.segments_shipped = 0
        self._published = {
            wal for t, wal in map(parse_ship_name,
                                  transport.list_segments())
            if t is None or t == self.term}
        self._lock = threading.Lock()

    def ship_once(self) -> int:
        """One shipping round; returns segments published this round."""
        with self._lock:
            current = self.transport.read_term()
            if current > self.term:
                raise FencedError(
                    f"shipper at term {self.term} fenced: transport term "
                    f"is {current}")
            wal = getattr(self.engine, "_wal", None)
            if wal is None:
                raise ReplicationError(
                    "primary engine has no WAL attached — nothing to ship")
            wal.rotate(self.directory)
            shipped = 0
            for start_seq, path in wal_mod.wal_files(self.directory):
                name = os.path.basename(path)
                if name in self._published:
                    continue
                # Re-read wal.path for EVERY candidate rather than
                # capturing it once: the checkpoint thread rotates this
                # WAL concurrently (save_snapshot), so a file that did
                # not exist at our rotate() above may be the live file
                # now. A file that stops being wal.path can never become
                # live again (rotation only moves forward through seq
                # names), so candidate != wal.path at this instant proves
                # the candidate is closed and immutable — only then is it
                # safe to read it and mark it published. The live file is
                # simply picked up on a later round, after its rotation.
                if path == wal.path:
                    continue
                frame = encode_ship_frame(self.term, start_seq,
                                          pio.read_bytes(path))
                self._publish_with_retry(ship_segment_name(self.term, name),
                                         frame)
                self._published.add(name)
                shipped += 1
            self.segments_shipped += shipped
            self.transport.write_heartbeat("primary", {
                "term": self.term, "last_seq": int(wal.last_seq),
                "time": time.time()})
            return shipped

    def _publish_with_retry(self, name: str, frame: bytes) -> None:
        deadline = (None if self.send_timeout_s is None
                    else time.monotonic() + self.send_timeout_s)
        last_err: Exception | None = None
        for attempt in range(self.max_retries + 1):
            try:
                self.transport.publish(name, frame, term=self.term)
                return
            except FencedError:
                raise
            except Exception as e:
                last_err = e
                if attempt == self.max_retries:
                    break
                sleep = self.backoff_s * (2 ** attempt)
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    sleep = min(sleep, remaining)
                time.sleep(sleep)
        raise ReplicationError(
            f"publishing segment {name} failed after "
            f"{self.max_retries + 1} attempts: {last_err}") from last_err


# ---------------------------------------------------------------------------
# standby side: the replica
# ---------------------------------------------------------------------------

class ReplicationLag(NamedTuple):
    """How far a standby trails its primary, in both operational units."""

    seqs: int       # records the primary acknowledged that we've not applied
    seconds: float  # age of the primary heartbeat those seqs came from
    #                 (0.0 when fully caught up or no heartbeat exists yet)


class StandbyReplica:
    """Warm follower: replays shipped WAL segments into a live engine.

    The engine must have NO WAL writer attached — replay goes through
    ``apply_record`` (the same deterministic mutators recovery uses), so
    the standby's state is bit-identical to the primary's over the
    applied prefix and read-only queries are served from it at any moment.

    Replay is *idempotent and gap-loud*: records at or below
    ``applied_seq`` are skipped exactly (re-shipped or duplicated
    segments are harmless), the first record above it must be
    ``applied_seq + 1`` (a dropped segment raises ``ReplicationError``),
    and records the transport's term chart proves are a fenced primary's
    leftovers — minted under term ``t`` at a seq a newer term's chain has
    rewritten — are skipped (counted in ``records_stale``), never
    replayed and never an excuse to stop following the live chain.
    """

    def __init__(self, engine, transport, *, start_seq: int = 0,
                 max_retries: int = 4, backoff_s: float = 0.01):
        if getattr(engine, "_wal", None) is not None:
            raise ValueError(
                "standby engine must not have a WAL attached — replay "
                "must not re-log (promotion attaches one)")
        self.engine = engine
        self.transport = transport
        self.applied_seq = int(start_seq)
        self.records_replayed = 0
        self.records_stale = 0
        self.max_term = 0
        self.max_retries = int(max_retries)
        self.backoff_s = float(backoff_s)
        self._seen: set[str] = set()
        self._lock = threading.RLock()  # promote() drains via poll_once()

    def poll_once(self) -> int:
        """Fetch + replay every new shipped segment; returns records applied."""
        with self._lock:
            applied = 0
            chart = self.transport.term_chart()
            for name in self.transport.list_segments():
                if name in self._seen:
                    continue
                frame = self._fetch_with_retry(name)
                term, _start_seq, payload = decode_ship_frame(frame, name)
                self.max_term = max(self.max_term, term)
                records, _valid, clean = wal_mod.scan_wal_bytes(payload, name)
                if not clean:
                    raise ReplicationError(
                        f"shipped segment {name} ends torn — closed "
                        "segments are always complete; refusing to replay")
                for rec in records:
                    if _stale_record(chart, term, rec.seq):
                        self.records_stale += 1
                        continue  # a fenced primary's leftover: inert
                    if rec.seq <= self.applied_seq:
                        continue  # duplicate delivery: already applied
                    if rec.seq != self.applied_seq + 1:
                        raise ReplicationError(
                            f"sequence gap in shipped chain: expected "
                            f"{self.applied_seq + 1}, segment {name} holds "
                            f"{rec.seq} — a segment was dropped")
                    wal_mod.apply_record(self.engine, rec)
                    self.applied_seq = rec.seq
                    self.records_replayed += 1
                    applied += 1
                self._seen.add(name)
            self.transport.write_heartbeat("standby", {
                "term": self.max_term, "applied_seq": self.applied_seq,
                "time": time.time()})
            return applied

    def _fetch_with_retry(self, name: str) -> bytes:
        last_err: Exception | None = None
        for attempt in range(self.max_retries + 1):
            try:
                return self.transport.fetch(name)
            except ReplicationError:
                raise  # typed = permanent (missing segment), don't spin
            except Exception as e:
                last_err = e
                if attempt < self.max_retries:
                    time.sleep(self.backoff_s * (2 ** attempt))
        raise ReplicationError(
            f"fetching segment {name} failed after "
            f"{self.max_retries + 1} attempts: {last_err}") from last_err

    def lag(self) -> ReplicationLag:
        """Current lag vs the primary's last heartbeat (0/0.0 when caught
        up, or before any heartbeat arrives — absence of a primary is a
        liveness question for the failure detector, not a lag number)."""
        hb = self.transport.read_heartbeat("primary")
        if hb is None:
            return ReplicationLag(0, 0.0)
        seqs = max(0, int(hb.get("last_seq", 0)) - self.applied_seq)
        if seqs == 0:
            return ReplicationLag(0, 0.0)
        return ReplicationLag(
            seqs, max(0.0, time.time() - float(hb.get("time", 0.0))))

    def promote(self, directory: str, *, term: int | None = None) -> int:
        """Fenced failover: drain, bump the term, become writable.

        1. Drain: replay every segment already in the transport, so no
           shipped record is left behind.
        2. Bump: install ``max(transport, seen) + 1`` (or the explicit
           ``term``) as the new transport term — atomically, recording
           ``applied_seq + 1`` as the new term's chain start in the term
           chart (so the deposed primary's unshipped suffix is provably
           stale to every follower); losing a race to an even newer term
           raises ``FencedError`` and changes nothing locally.
        3. Snapshot: checkpoint the drained state into ``directory`` with
           the new term and ``wal_seq = applied_seq`` (the replica applied
           records without logging them, so the manifest must pin the
           exact prefix the state folds in).
        4. Attach: a fresh ``WALWriter`` at ``applied_seq + 1`` carrying
           the new term and a fence guard.

        Returns the new term. From the transport's perspective the old
        primary is fenced the instant step 2 lands.
        """
        from repro_torch.persist.snapshot import save_snapshot  # cycle-free import
        with self._lock:
            while self.poll_once():  # drain what the transport already holds
                pass
            current = self.transport.read_term()
            new_term = (max(current, self.max_term) + 1 if term is None
                        else int(term))
            self.transport.bump_term(  # FencedError if stale
                new_term, start_seq=self.applied_seq + 1)
            self.max_term = new_term
            os.makedirs(directory, exist_ok=True)
            save_snapshot(self.engine, directory, term=new_term,
                          wal_seq=self.applied_seq)
            writer = wal_mod.WALWriter(
                os.path.join(directory,
                             wal_mod.wal_name(self.applied_seq + 1)),
                self.applied_seq + 1, term=new_term,
                guard=make_fence_guard(self.transport, new_term))
            self.engine.attach_wal(writer)
            return new_term

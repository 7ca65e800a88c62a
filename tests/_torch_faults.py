"""Fault-injection harness for the port's durable-index subsystem (a copy of
``tests/faults.py`` that patches ``repro_torch.persist.io``).

Every persistence byte crosses the primitives in ``repro_torch.persist.io``
(``write_bytes`` / ``read_bytes`` / ``append_record`` and the group-commit
pair ``append_bytes`` / ``fsync_file``) — see that module's docstring.
``FaultInjector`` monkey-wraps exactly those, so the harness can
deterministically produce:

  - **torn writes**: a snapshot segment / WAL append persists only a prefix
    of its bytes (crash mid-write);
  - **bit flips**: one byte of a written or read file is corrupted
    (storage rot the CRCs must catch);
  - **short reads**: ``read_bytes`` returns a prefix (truncated file, torn
    download);
  - **crash-at-step-N**: the N-th I/O call raises ``SimulatedCrash`` after
    optionally persisting a prefix, aborting whatever multi-file operation
    was in flight (the in-process analogue of the kill-9 subprocess drill
    in ``tools/crash_test_torch.py``).

Plus filesystem-level corruptors (``flip_byte_in`` / ``truncate_file`` /
``delete_file``) for damaging completed directories. The recovery contract
under every fault is *prefix-or-loud* (repro_torch.persist.errors): reopening
yields either a bit-identical engine over a prefix of the acknowledged
mutations, or a typed ``CorruptSnapshotError``/``CorruptWALError`` —
asserted by tests/test_torch_persist.py.

Importable from tests and tools (lives in ``tests/`` but has no pytest
dependency).
"""
from __future__ import annotations

import os
import random

from repro_torch.persist import io as pio


class SimulatedCrash(BaseException):
    """Raised by the injector at the chosen I/O step. Deliberately NOT an
    Exception subclass so production code cannot accidentally swallow it —
    only the test harness catches it (like a real kill-9 would not be
    caught)."""


class FaultInjector:
    """Context manager wrapping the persistence I/O seam.

    Counts write-side calls (``write_bytes`` + ``append_record``); when the
    count hits ``crash_at_write`` the call persists only ``torn_fraction``
    of its payload and raises ``SimulatedCrash``. Independently,
    ``flip_write_byte``/``flip_read_byte`` corrupt one byte of the N-th
    written/read buffer (no crash — silent rot), and ``short_read_at``
    truncates the N-th read to half. All counters are 1-based.
    """

    def __init__(self, *, crash_at_write: int | None = None,
                 torn_fraction: float = 0.5,
                 flip_write_byte: int | None = None,
                 flip_read_byte: int | None = None,
                 short_read_at: int | None = None,
                 seed: int = 0):
        self.crash_at_write = crash_at_write
        self.torn_fraction = torn_fraction
        self.flip_write_byte = flip_write_byte
        self.flip_read_byte = flip_read_byte
        self.short_read_at = short_read_at
        self.rng = random.Random(seed)
        self.writes = 0
        self.reads = 0
        self._saved: dict[str, object] = {}

    # -- byte corruption -----------------------------------------------------

    def _flip(self, data: bytes) -> bytes:
        if not data:
            return data
        i = self.rng.randrange(len(data))
        return data[:i] + bytes([data[i] ^ (1 << self.rng.randrange(8))]) \
            + data[i + 1:]

    def _on_write(self, data: bytes) -> bytes:
        self.writes += 1
        if self.writes == self.flip_write_byte:
            data = self._flip(data)
        if self.writes == self.crash_at_write:
            return None  # sentinel: crash, persisting a torn prefix
        return data

    # -- wrapped primitives --------------------------------------------------

    def _write_bytes(self, path: str, data: bytes) -> None:
        out = self._on_write(data)
        if out is None:
            torn = data[:int(len(data) * self.torn_fraction)]
            self._orig_write(path, torn)
            raise SimulatedCrash(f"write_bytes({path}) at step {self.writes}")
        self._orig_write(path, out)

    def _append_record(self, f, data: bytes) -> None:
        out = self._on_write(data)
        if out is None:
            self._orig_append(f, data[:int(len(data) * self.torn_fraction)])
            raise SimulatedCrash(f"append_record at step {self.writes}")
        self._orig_append(f, out)

    def _append_bytes(self, f, data: bytes) -> None:
        # the group-commit write half: same write-side counter, so a crash
        # sweep covers deferred-fsync appends exactly like fsync'd ones
        out = self._on_write(data)
        if out is None:
            self._orig_append_b(f, data[:int(len(data) * self.torn_fraction)])
            raise SimulatedCrash(f"append_bytes at step {self.writes}")
        self._orig_append_b(f, out)

    def _read_bytes(self, path: str) -> bytes:
        data = self._orig_read(path)
        self.reads += 1
        if self.reads == self.flip_read_byte:
            data = self._flip(data)
        if self.reads == self.short_read_at:
            data = data[:len(data) // 2]
        return data

    # -- install / restore ---------------------------------------------------

    def __enter__(self) -> "FaultInjector":
        self._orig_write = pio.write_bytes
        self._orig_append = pio.append_record
        self._orig_append_b = pio.append_bytes
        self._orig_read = pio.read_bytes
        pio.write_bytes = self._write_bytes
        pio.append_record = self._append_record
        pio.append_bytes = self._append_bytes
        pio.read_bytes = self._read_bytes
        return self

    def __exit__(self, *exc) -> None:
        pio.write_bytes = self._orig_write
        pio.append_record = self._orig_append
        pio.append_bytes = self._orig_append_b
        pio.read_bytes = self._orig_read


# ---------------------------------------------------------------------------
# filesystem-level corruptors for completed directories
# ---------------------------------------------------------------------------

def flip_byte_in(path: str, offset: int | None = None, seed: int = 0) -> None:
    """Flip one bit of one byte of the file at ``path`` in place."""
    rng = random.Random(seed)
    with open(path, "r+b") as f:
        f.seek(0, os.SEEK_END)
        size = f.tell()
        if size == 0:
            return
        i = rng.randrange(size) if offset is None else offset
        f.seek(i)
        b = f.read(1)[0]
        f.seek(i)
        f.write(bytes([b ^ (1 << rng.randrange(8))]))


def truncate_file(path: str, fraction: float = 0.5) -> None:
    """Cut the file to a prefix (torn write / lost tail)."""
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(int(size * fraction))


def delete_file(path: str) -> None:
    os.remove(path)


def snapshot_files(directory: str) -> list[str]:
    """Every file of the CURRENT snapshot (segments + shard manifests),
    paths absolute, sorted for determinism."""
    import json
    with open(os.path.join(directory, "MANIFEST.json")) as f:
        manifest = json.load(f)
    rels = [e["file"] for e in manifest["segments"].values()]
    for sh in manifest.get("shards", ()):
        rels.append(sh["manifest"])
        with open(os.path.join(directory, sh["manifest"])) as f:
            rels.extend(e["file"]
                        for e in json.load(f)["segments"].values())
    return sorted(os.path.join(directory, r) for r in rels)


def wal_paths(directory: str) -> list[str]:
    from repro_torch.persist import wal_files
    return [p for _s, p in wal_files(directory)]

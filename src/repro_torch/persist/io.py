"""Durable-I/O primitives: the single seam every persistence byte crosses
(counterpart of ``repro.persist.io``).

All snapshot and WAL bytes go through the four module-level functions below
(``write_bytes`` / ``read_bytes`` / ``append_record`` / ``fsync_dir``), so
the fault-injection harness (``tests/_torch_faults.py``) can deterministically
inject torn writes, bit flips, and short reads by wrapping exactly these —
no fault path exists that the harness cannot reach.

Durability contract (docs/persistence.md):

  - ``atomic_write_bytes`` is the only way a *named* snapshot/manifest file
    comes into existence: full bytes to a temp file, ``fsync``, then
    ``os.replace`` + directory fsync. A crash at any step leaves either the
    old file or the new file, never a torn one under its real name.
  - ``append_record`` fsyncs before returning — a WAL append that returned
    is on disk; the caller may acknowledge the mutation.
"""
from __future__ import annotations

import os
import zlib


def crc32(data: bytes) -> int:
    """Unsigned CRC-32 of ``data`` (zlib polynomial, masked to 32 bits)."""
    return zlib.crc32(data) & 0xFFFFFFFF


def write_bytes(path: str, data: bytes) -> None:
    """Write ``data`` to ``path`` and fsync the file. Patchable primitive."""
    with open(path, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())


def read_bytes(path: str) -> bytes:
    """Read the whole file at ``path``. Patchable primitive."""
    with open(path, "rb") as f:
        return f.read()


def append_record(f, data: bytes) -> None:
    """Append ``data`` to the open binary file ``f`` and fsync.

    The WAL's acknowledge point: when this returns, the record survives
    kill-9. Patchable primitive.
    """
    f.write(data)
    f.flush()
    os.fsync(f.fileno())


def append_bytes(f, data: bytes) -> None:
    """Append ``data`` WITHOUT fsync — the group-commit half of the WAL
    write path (``WALWriter(fsync_interval=...)``): bytes reach the OS, the
    durability point is the next ``fsync_file``. Patchable primitive.
    """
    f.write(data)
    f.flush()


def fsync_file(f) -> None:
    """fsync an open file — the deferred half of a group commit. Patchable
    primitive."""
    os.fsync(f.fileno())


def fsync_dir(path: str) -> None:
    """fsync a directory so a rename/create inside it is durable.

    Best-effort: some filesystems refuse O_RDONLY fsync on directories;
    the rename itself is still atomic there.
    """
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def atomic_write_bytes(path: str, data: bytes) -> None:
    """Publish ``data`` at ``path`` via temp file + fsync + atomic rename.

    The temp file lives next to the target (same filesystem, so the rename
    is atomic) and carries the pid so concurrent writers never collide.
    """
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        write_bytes(tmp, data)
        os.replace(tmp, path)
    finally:
        # a failed (torn) write must not leave the temp file behind — it is
        # unnamed garbage either way, but tests assert clean directories
        if os.path.exists(tmp):
            try:
                os.remove(tmp)
            except OSError:
                pass
    fsync_dir(os.path.dirname(path) or ".")

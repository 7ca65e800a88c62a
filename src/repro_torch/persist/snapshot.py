"""Checksummed engine snapshots + recovery (counterpart of
``repro.persist.snapshot``; the reference's docs/persistence.md).

A durable-index directory holds three kinds of entry, in the reference's
formats, so a directory written by either package opens in the other:

    MANIFEST.json            atomic pointer to the last COMPLETE snapshot
                             (schema 2; schema 1 migrates on read)
    snap-NNNNNN/*.npy        per-segment CRC-verified array files
    wal-############.log     the write-ahead mutation log chain

``save_snapshot`` captures (WAL position, engine state) atomically under
the engine's mutation lock, serializes every segment to a *new* ``snap-``
directory (a segment whose bytes match the parent manifest's is referenced,
not rewritten: a delta snapshot), and only then atomically replaces the
manifest; older snapshots and WAL files the new manifest covers are then
garbage collected.

**The capture.** The reference serializes its immutable state outside the
lock. The port's engines write into their tensors in place, so the capture
clones every tensor a mutation writes in place (the list store, base,
norms, live-row bitmap; the sharded engine's per-shard ones) on the device,
under the engine's mutation lock and, for ``SearchEngine``, inside
``graphs.ordered()`` (so the clone is queued after the last write and
before the next one). Only that device copy stalls searches and writes;
the device-to-host copies (on a stream of their own, so that they do not
queue ahead of later searches), CRCs and file I/O run outside the lock.
The clone needs as much device memory again for a moment. The manifest's
``delta`` records the capture's seconds (``capture_s``).

Recovery (``open_engine``) = load the manifest's snapshot (every segment
CRC-checked) onto ``device`` (None = the CUDA card), replay WAL records past
the snapshot's ``wal_seq`` through the engine's own mutators, and attach a
fresh WAL writer at the next sequence number.

Coarse quantizers: an HNSW engine records ``hnsw_m`` / ``ef_construction``
(the port's ``build_hnsw`` builds the reference's graph bit for bit) and a
tree engine is rebuilt with the port's ``build_tree``. The port also
writes the quantizer's arrays as segments (``hnsw_*`` or ``tree_*``, the
``interop`` names), which it prefers on load, so its own recovery keeps the
very quantizer it saved; the reference ignores them. A custom quantizer is
refused at save.
"""
from __future__ import annotations

import io as _io
import json
import os
import shutil
import threading
import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import interop
from repro_torch.core import lists as lists_mod
from repro_torch.core.pq import PQCodebook
from repro_torch.device import resolve_device
from repro_torch.engine.engine import EngineConfig, SearchEngine
from repro_torch.engine.sharded import ShardedEngine, _ShardState
from repro_torch.kernels import ops as ops_mod
from repro_torch.persist import io as pio
from repro_torch.persist import wal as wal_mod
from repro_torch.persist.errors import CorruptSnapshotError, NoSnapshotError

MANIFEST_NAME = "MANIFEST.json"
SCHEMA = 2
_KNOWN_SCHEMAS = (1, 2)  # 1 = pre-replication (no term/parent/delta fields)
_SNAPSHOT_KINDS = ("single", "sharded")


class RecoveryInfo(NamedTuple):
    """What ``open_engine`` reconstructed, for assertions and ops logs."""

    snapshot: str        # snap-NNNNNN directory the manifest named
    wal_seq: int         # mutations already folded into that snapshot
    replayed: int        # WAL records replayed on top of it
    last_seq: int        # wal_seq + replayed == total acknowledged mutations
    truncated_bytes: int # torn tail dropped from the final WAL file (crash
    #                      mid-append; 0 on a clean shutdown)
    term: int = 0        # fencing term the manifest recorded (replication)


# ---------------------------------------------------------------------------
# segment primitives
# ---------------------------------------------------------------------------

def _npy_bytes(arr: np.ndarray) -> bytes:
    bio = _io.BytesIO()
    np.save(bio, np.asarray(arr), allow_pickle=False)
    return bio.getvalue()


class _DeltaStats:
    """Per-checkpoint accounting: what was rewritten vs referenced, and the
    seconds the capture held the engine's lock."""

    def __init__(self, capture_s: float = 0.0):
        self.bytes_written = 0
        self.bytes_reused = 0
        self.segments_written = 0
        self.segments_reused = 0
        self.capture_s = capture_s

    def as_meta(self) -> dict:
        return {"bytes_written": self.bytes_written,
                "bytes_reused": self.bytes_reused,
                "segments_written": self.segments_written,
                "segments_reused": self.segments_reused,
                "capture_s": self.capture_s}


def _write_segments(directory: str, seg_dir: str,
                    arrays: dict[str, np.ndarray],
                    parent: dict | None = None,
                    stats: _DeltaStats | None = None) -> dict:
    """Write each array as ``<seg_dir>/<name>.npy``; return manifest entries
    (file paths relative to the root ``directory``). An array whose bytes
    CRC+size-match the ``parent`` entry of the same name is referenced in
    place instead (a delta snapshot)."""
    entries = {}
    for name, arr in arrays.items():
        data = _npy_bytes(arr)
        crc = pio.crc32(data)
        old = None if parent is None else parent.get(name)
        if (old is not None and old.get("crc") == crc
                and old.get("size") == len(data)
                and os.path.exists(os.path.join(directory, old["file"]))):
            entries[name] = {"file": old["file"], "crc": crc,
                             "size": len(data)}
            if stats is not None:
                stats.bytes_reused += len(data)
                stats.segments_reused += 1
            continue
        rel = os.path.join(os.path.relpath(seg_dir, directory),
                           f"{name}.npy")
        pio.write_bytes(os.path.join(directory, rel), data)
        entries[name] = {"file": rel, "crc": crc, "size": len(data)}
        if stats is not None:
            stats.bytes_written += len(data)
            stats.segments_written += 1
    return entries


def _read_verified(directory: str, entry: dict, what: str) -> bytes:
    path = os.path.join(directory, entry["file"])
    try:
        data = pio.read_bytes(path)
    except OSError as e:
        raise CorruptSnapshotError(
            f"{what} segment {entry['file']} unreadable: {e}") from e
    if len(data) != entry["size"]:
        raise CorruptSnapshotError(
            f"{what} segment {entry['file']} truncated: "
            f"{len(data)} bytes, manifest says {entry['size']}")
    if pio.crc32(data) != entry["crc"]:
        raise CorruptSnapshotError(
            f"{what} segment {entry['file']} failed its CRC check")
    return data


def _load_array(directory: str, entry: dict, what: str) -> np.ndarray:
    data = _read_verified(directory, entry, what)
    try:
        return np.load(_io.BytesIO(data), allow_pickle=False)
    except Exception as e:
        raise CorruptSnapshotError(
            f"{what} segment {entry['file']} undecodable: {e}") from e


# ---------------------------------------------------------------------------
# manifest
# ---------------------------------------------------------------------------

def _manifest_crc(manifest: dict) -> int:
    """CRC of the manifest body over a canonical serialization, so the
    manifest protects its own fields (``wal_seq`` above all)."""
    body = {k: v for k, v in manifest.items() if k != "manifest_crc"}
    return pio.crc32(json.dumps(body, sort_keys=True,
                                separators=(",", ":")).encode("utf-8"))


def read_manifest(directory: str) -> dict:
    """The directory's manifest, or ``NoSnapshotError`` if none exists; a
    present-but-unparseable one is ``CorruptSnapshotError``. Schema-1
    manifests (no term or parent) read as term 0 with no parent."""
    path = os.path.join(directory, MANIFEST_NAME)
    try:
        data = pio.read_bytes(path)
    except FileNotFoundError:
        raise NoSnapshotError(
            f"no {MANIFEST_NAME} in {directory} — nothing was ever "
            "checkpointed here") from None
    try:
        manifest = json.loads(data.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise CorruptSnapshotError(
            f"{path} is not valid manifest JSON: {e}") from e
    if (manifest.get("schema") not in _KNOWN_SCHEMAS
            or manifest.get("kind") not in _SNAPSHOT_KINDS):
        raise CorruptSnapshotError(
            f"{path}: unknown schema/kind "
            f"{manifest.get('schema')!r}/{manifest.get('kind')!r}")
    if manifest.get("manifest_crc") != _manifest_crc(manifest):
        raise CorruptSnapshotError(f"{path} failed its self-CRC check")
    manifest.setdefault("term", 0)
    manifest.setdefault("parent", None)
    return manifest


def _next_snap_name(directory: str) -> str:
    nums = [0]
    for name in os.listdir(directory):
        if name.startswith("snap-") and name[5:].isdigit():
            nums.append(int(name[5:]))
    return f"snap-{max(nums) + 1:06d}"


# ---------------------------------------------------------------------------
# capture (under the engine's lock) and serialization (outside it)
# ---------------------------------------------------------------------------

def _clone(t: torch.Tensor | None) -> torch.Tensor | None:
    return None if t is None else t.clone()


def _host(tensors: dict) -> dict[str, np.ndarray]:
    """Host copies of the captured tensors (None ones dropped). On the card
    they are made on a stream of their own, after the clones: a copy on the
    engine's stream would hold every later search back for the whole
    device-to-host transfer of the state."""
    cuda = [v for v in tensors.values() if v is not None and v.is_cuda]
    if not cuda:
        return {k: v.numpy() for k, v in tensors.items() if v is not None}
    side = torch.cuda.Stream(cuda[0].device)
    side.wait_stream(torch.cuda.current_stream(cuda[0].device))
    with torch.cuda.stream(side):
        return {k: v.cpu().numpy() for k, v in tensors.items()
                if v is not None}


def _capture_single(engine: SearchEngine) -> tuple[dict, dict]:
    """(device tensors, meta) of the engine's state. The caller holds the
    mutation lock; the clones are queued after every earlier write."""
    if engine.coarse_kind not in ("flat", "hnsw", "tree"):
        raise ValueError(
            f"cannot snapshot an engine with a custom coarse quantizer "
            f"({engine.coarse_kind!r}) — only flat/hnsw/tree rebuild "
            "deterministically from the centroids")
    with engine.graphs.ordered():
        st = engine._state
        lists = st.index.lists
        tensors = {"codes": lists.codes.clone(), "ids": lists.ids.clone(),
                   "sizes": lists.sizes.clone(), "attrs": _clone(lists.attrs),
                   # never written in place: read as they are
                   "centroids": st.index.centroids,
                   "codebook": st.index.codebook.codewords,
                   "base": _clone(st.base),
                   "base_norms": _clone(st.base_norms),
                   "live_bits": _clone(st.live_bits),
                   "ns_member": engine.ns_member}
    meta = {"config": dict(engine.config._asdict()),
            "coarse_kind": engine.coarse_kind,
            "hnsw_m": engine.hnsw_m,
            "ef_construction": engine.ef_construction,
            "epoch": int(st.epoch),
            "n_tombstones": int(st.n_tombstones)}
    return tensors, meta


def _serialize_single(engine: SearchEngine, arrays: dict, directory: str,
                      snap_dir: str, parent: dict | None,
                      stats: _DeltaStats) -> tuple[dict, None]:
    arrays = dict(arrays, **interop.arrays_from_coarse(engine.coarse))
    parent_segs = None if parent is None else parent.get("segments")
    return (_write_segments(directory, snap_dir, arrays, parent_segs, stats),
            None)


def _parent_shard_segments(directory: str, parent: dict | None,
                           num_shards: int) -> list[dict | None]:
    """Per-shard segment tables of the parent manifest (for delta reuse);
    a shard whose sub-manifest cannot be verified simply gets no reuse."""
    out: list[dict | None] = [None] * num_shards
    if parent is None or len(parent.get("shards", ())) != num_shards:
        return out
    for j, entry in enumerate(parent["shards"]):
        try:
            sub = json.loads(_read_verified(
                directory, {"file": entry["manifest"], "crc": entry["crc"],
                            "size": entry["size"]},
                "parent shard manifest").decode("utf-8"))
            out[j] = sub["segments"]
        except (CorruptSnapshotError, KeyError, UnicodeDecodeError,
                json.JSONDecodeError):
            out[j] = None
    return out


def _capture_sharded(engine: ShardedEngine) -> tuple[dict, dict]:
    """(device tensors, meta) of a sharded engine's state; the caller holds
    its mutation lock, which every search of it also takes."""
    st = engine._state
    tensors = {"centroids": engine.centroids,
               "codebook": engine.codebook.codewords,
               "member_s": engine.member_s,
               "centroids_s": st.centroids_s, "real_s": st.real_s,
               "gids_s": _clone(st.gids_s), "base_s": _clone(st.base_s),
               "norms_s": _clone(st.norms_s)}
    tensors.update({f"lists_s.{k}": _clone(v)
                    for k, v in st.lists_s._asdict().items()})
    meta = {"config": dict(engine.config._asdict()),
            "num_shards": engine.num_shards,
            "nlist_global": int(engine.centroids.shape[0]),
            "rows_used": [int(r) for r in st.rows_used],
            "epoch": int(st.epoch),
            "n_tombstones": int(st.n_tombstones)}
    return tensors, meta


def _serialize_sharded(engine: ShardedEngine, per: dict,
                       directory: str, snap_dir: str, parent: dict | None,
                       stats: _DeltaStats) -> tuple[dict, list]:
    arrays = {k: per[k] for k in ("centroids", "codebook", "member_s")
              if k in per}
    parent_segs = None if parent is None else parent.get("segments")
    segments = _write_segments(directory, snap_dir, arrays, parent_segs,
                               stats)
    store = {k[len("lists_s."):]: v for k, v in per.items()  # (S, ...)
             if k.startswith("lists_s.")}
    parent_sh = _parent_shard_segments(directory, parent, engine.num_shards)
    shards = []
    for j in range(engine.num_shards):
        shard_dir = os.path.join(snap_dir, f"shard-{j:02d}")
        os.makedirs(shard_dir, exist_ok=True)
        sh = {k: v[j] for k, v in store.items()}
        sh["centroids"] = per["centroids_s"][j]
        sh["real"] = per["real_s"][j]
        sh["gids"] = per["gids_s"][j]
        if "base_s" in per:
            sh["base"] = per["base_s"][j]
            sh["norms"] = per["norms_s"][j]
        entries = _write_segments(directory, shard_dir, sh, parent_sh[j],
                                  stats)
        sub = json.dumps({"shard": j, "segments": entries},
                         indent=1).encode("utf-8")
        rel = os.path.join(os.path.relpath(shard_dir, directory),
                           "manifest.json")
        pio.write_bytes(os.path.join(directory, rel), sub)
        shards.append({"manifest": rel, "crc": pio.crc32(sub),
                       "size": len(sub)})
    return segments, shards


# ---------------------------------------------------------------------------
# save
# ---------------------------------------------------------------------------

def save_snapshot(engine, directory: str, *, term: int | None = None,
                  wal_seq: int | None = None) -> dict:
    """Checkpoint ``engine`` into ``directory``; returns the new manifest.

    The (WAL position, state) pair is captured atomically under the
    engine's mutation lock (rotating the WAL first, so every record the
    snapshot folds in lives in files GC may then delete; the state as
    device clones, the module docstring). Every segment is written and
    fsync'd BEFORE the manifest atomically flips to the new snapshot; a
    crash anywhere in between recovers from the old manifest plus the
    intact WAL chain. Works on ``SearchEngine`` and ``ShardedEngine``
    (per-shard manifests). Segments whose bytes match the parent
    manifest's are referenced, not rewritten (delta snapshots).

    ``term`` stamps the manifest with the replication fencing term
    (default: the previous manifest's, 0 on a fresh directory).
    ``wal_seq`` overrides the recorded WAL position, only for an engine
    WITHOUT an attached writer whose state folds in exactly that prefix
    (standby promotion).
    """
    os.makedirs(directory, exist_ok=True)
    try:
        parent = read_manifest(directory)
    except (NoSnapshotError, CorruptSnapshotError):
        parent = None  # fresh (or unreadable) parent -> full snapshot
    sharded = isinstance(engine, ShardedEngine)
    with engine._mutate_lock, torch.no_grad():
        t0 = time.perf_counter()
        wal = getattr(engine, "_wal", None)
        if wal is not None:
            wal.rotate(directory)
            wal_seq = wal.last_seq
        elif wal_seq is None:
            wal_seq = 0
        tensors, meta = (_capture_sharded(engine) if sharded
                         else _capture_single(engine))
        capture_s = time.perf_counter() - t0
    if term is None:
        term = 0 if parent is None else int(parent.get("term", 0))
    snap_name = _next_snap_name(directory)
    snap_dir = os.path.join(directory, snap_name)
    os.makedirs(snap_dir, exist_ok=True)
    stats = _DeltaStats(capture_s)
    arrays = _host(tensors)
    del tensors
    if sharded:
        segments, shards = _serialize_sharded(engine, arrays, directory,
                                              snap_dir, parent, stats)
        kind = "sharded"
    else:
        segments, shards = _serialize_single(engine, arrays, directory,
                                             snap_dir, parent, stats)
        kind = "single"
    del arrays
    # autotune verdicts ride along so a restored replica serves warm
    tmp = os.path.join(snap_dir, "autotune.tmp")
    ops_mod.save_autotune_cache(tmp)
    with open(tmp, "rb") as f:
        tune = f.read()
    os.remove(tmp)
    tune_crc = pio.crc32(tune)
    old_tune = None if parent is None else parent["segments"].get("autotune")
    if (old_tune is not None and old_tune.get("crc") == tune_crc
            and old_tune.get("size") == len(tune)
            and os.path.exists(os.path.join(directory, old_tune["file"]))):
        segments["autotune"] = {"file": old_tune["file"], "crc": tune_crc,
                                "size": len(tune)}
        stats.bytes_reused += len(tune)
        stats.segments_reused += 1
    else:
        rel = os.path.join(snap_name, "autotune.json")
        pio.write_bytes(os.path.join(directory, rel), tune)
        segments["autotune"] = {"file": rel, "crc": tune_crc,
                                "size": len(tune)}
        stats.bytes_written += len(tune)
        stats.segments_written += 1
    pio.fsync_dir(snap_dir)
    manifest = {"schema": SCHEMA, "kind": kind, "snapshot": snap_name,
                "term": int(term),
                "parent": None if parent is None else parent["snapshot"],
                "delta": stats.as_meta(),
                "wal_seq": int(wal_seq), "meta": meta, "segments": segments}
    if shards is not None:
        manifest["shards"] = shards
    manifest["manifest_crc"] = _manifest_crc(manifest)
    pio.atomic_write_bytes(os.path.join(directory, MANIFEST_NAME),
                           json.dumps(manifest, indent=1).encode("utf-8"))
    _gc(directory, manifest, wal_seq,
        keep=None if wal is None else wal.path)
    return manifest


def _reachable_snaps(manifest: dict) -> set[str]:
    """Snapshot directories the manifest still references: its own plus
    any parent directories that delta entries point into."""
    rels = [e["file"] for e in manifest["segments"].values()]
    rels += [sh["manifest"] for sh in manifest.get("shards", ())]
    keep = {manifest["snapshot"]}
    for rel in rels:
        head = rel.replace(os.sep, "/").split("/", 1)[0]
        if head.startswith("snap-"):
            keep.add(head)
    return keep


def _gc(directory: str, manifest: dict, wal_seq: int,
        keep: str | None) -> None:
    """Drop snapshots and WAL files the new manifest supersedes, once it is
    durable. A snapshot directory survives while any current segment (or
    shard sub-manifest's segment) references into it; a WAL file goes when
    a later file exists and every record it could hold is <= ``wal_seq``;
    the final file and the active writer's file always stay."""
    reachable = _reachable_snaps(manifest)
    for sh in manifest.get("shards", ()):
        try:
            with open(os.path.join(directory, sh["manifest"])) as f:
                sub = json.load(f)
            for e in sub.get("segments", {}).values():
                head = e["file"].replace(os.sep, "/").split("/", 1)[0]
                if head.startswith("snap-"):
                    reachable.add(head)
        except (OSError, json.JSONDecodeError, KeyError):
            continue  # unreadable sub-manifest: keep GC conservative below
    for name in os.listdir(directory):
        if (name.startswith("snap-") and name not in reachable
                and os.path.isdir(os.path.join(directory, name))):
            shutil.rmtree(os.path.join(directory, name), ignore_errors=True)
    files = wal_mod.wal_files(directory)
    for i, (_start, path) in enumerate(files[:-1]):
        covered = files[i + 1][0] <= wal_seq + 1
        if covered and path != keep:
            try:
                os.remove(path)
            except OSError:
                pass


# ---------------------------------------------------------------------------
# load + recovery
# ---------------------------------------------------------------------------

def _deserialize_single(directory: str, manifest: dict,
                        dev: torch.device) -> SearchEngine:
    segs = manifest["segments"]
    meta = manifest["meta"]
    arrays = {name: _load_array(directory, entry, "snapshot")
              for name, entry in segs.items() if name != "autotune"}
    index = interop.index_from_arrays(arrays, dev)
    coarse = interop.coarse_from_arrays(arrays, dev) or meta["coarse_kind"]
    engine = SearchEngine(
        index,
        base=(torch.from_numpy(np.array(arrays["base"], np.float32)).to(dev)
              if "base" in arrays else None),
        coarse=coarse, config=EngineConfig(**meta["config"]),
        hnsw_m=int(meta["hnsw_m"]),
        ef_construction=int(meta["ef_construction"]),
        namespaces=arrays.get("ns_member"),
        base_norms=(torch.from_numpy(np.array(arrays["base_norms"],
                                              np.float32)).to(dev)
                    if "base_norms" in arrays else None),
        live_bits=(torch.from_numpy(np.array(arrays["live_bits"], np.uint8))
                   if "live_bits" in arrays else None))
    if engine.n_tombstones != int(meta["n_tombstones"]):
        raise CorruptSnapshotError(
            f"the store holds {engine.n_tombstones} tombstones, the manifest "
            f"says {meta['n_tombstones']}")
    engine._state = engine._state._replace(epoch=int(meta["epoch"]))
    return engine


def _deserialize_sharded(directory: str, manifest: dict,
                         dev: torch.device) -> ShardedEngine:
    segs = manifest["segments"]
    meta = manifest["meta"]
    num_shards = int(meta["num_shards"])
    if len(manifest.get("shards", ())) != num_shards:
        raise CorruptSnapshotError(
            f"manifest lists {len(manifest.get('shards', ()))} shard "
            f"manifests but meta says num_shards={num_shards}")
    per_shard: list[dict[str, np.ndarray]] = []
    for entry in manifest["shards"]:
        sub_bytes = _read_verified(directory, {"file": entry["manifest"],
                                               "crc": entry["crc"],
                                               "size": entry["size"]},
                                   "shard manifest")
        try:
            sub = json.loads(sub_bytes.decode("utf-8"))
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise CorruptSnapshotError(
                f"shard manifest {entry['manifest']} unparseable: {e}") from e
        per_shard.append({k: _load_array(directory, v, "shard snapshot")
                          for k, v in sub["segments"].items()})

    def stack(name, dtype):
        return torch.from_numpy(np.stack([np.asarray(sh[name], dtype)
                                          for sh in per_shard])).to(dev)

    def top(name, dtype):
        return torch.from_numpy(np.array(
            _load_array(directory, segs[name], "snapshot"), dtype)).to(dev)

    lists_s = lists_mod.ListStore(
        codes=stack("codes", np.uint8), ids=stack("ids", np.int32),
        sizes=stack("sizes", np.int32),
        attrs=stack("attrs", np.int32) if "attrs" in per_shard[0] else None)
    has_base = "base" in per_shard[0]
    n_tomb = int(meta["n_tombstones"])
    engine = object.__new__(ShardedEngine)
    engine.num_shards = num_shards
    engine.device = dev
    engine.config = EngineConfig(**meta["config"])
    engine.codebook = PQCodebook(top("codebook", np.float32))
    engine.centroids = top("centroids", np.float32)
    engine.member_s = (top("member_s", bool) if "member_s" in segs
                       else None)
    engine._state = _ShardState(
        centroids_s=stack("centroids", np.float32), lists_s=lists_s,
        real_s=stack("real", bool),
        base_s=stack("base", np.float32) if has_base else None,
        gids_s=stack("gids", np.int32),
        norms_s=stack("norms", np.float32) if has_base else None,
        live_s=lists_mod.live_filter_bits(lists_s) if n_tomb else None,
        rows_used=tuple(int(r) for r in meta["rows_used"]),
        epoch=int(meta["epoch"]), n_tombstones=n_tomb)
    engine._mutate_lock = threading.RLock()
    engine._locator = None
    engine._wal = None
    return engine


def load_snapshot(directory: str, *, device=None):
    """(engine, manifest) from the last complete snapshot on ``device``
    (None = the CUDA card; raises without one) — NO WAL replay. Serving
    boots through ``open_engine``, which replays the WAL too."""
    dev = resolve_device(device)
    manifest = read_manifest(directory)
    if manifest["kind"] == "sharded":
        engine = _deserialize_sharded(directory, manifest, dev)
    else:
        engine = _deserialize_single(directory, manifest, dev)
    if "autotune" in manifest["segments"]:
        tune = _read_verified(directory, manifest["segments"]["autotune"],
                              "autotune")
        tmp = os.path.join(directory, ".autotune.load.tmp")
        with open(tmp, "wb") as f:
            f.write(tune)
        try:
            ops_mod.load_autotune_cache(tmp)
        finally:
            os.remove(tmp)
    return engine, manifest


def open_engine(directory: str, *, attach: bool = True, device=None):
    """Recover: last snapshot + WAL replay on ``device`` (None = the CUDA
    card); returns (engine, RecoveryInfo).

    The recovered engine equals the never-crashed engine bit for bit over
    the acknowledged prefix the directory holds. A torn record at the tail
    of the FINAL WAL file (a crash mid-append) is truncated away; any
    other damage raises ``CorruptSnapshotError`` / ``CorruptWALError``.
    With ``attach=True`` a fresh WAL writer is attached at the next
    sequence number, so the engine is durable again at once.
    """
    engine, manifest = load_snapshot(directory, device=device)
    wal_seq = int(manifest["wal_seq"])
    truncated = 0
    files = wal_mod.wal_files(directory)
    if files:
        last_path = files[-1][1]
        _, valid, clean = wal_mod.scan_wal(last_path)
        if not clean:
            truncated = os.path.getsize(last_path) - valid
            with open(last_path, "r+b") as f:
                f.truncate(valid)
                f.flush()
                os.fsync(f.fileno())
    replayed = 0
    for rec in wal_mod.iter_wal(directory, after_seq=wal_seq):
        wal_mod.apply_record(engine, rec)
        replayed += 1
    last_seq = wal_seq + replayed
    term = int(manifest.get("term", 0))
    if attach:
        writer = wal_mod.WALWriter(
            os.path.join(directory, wal_mod.wal_name(last_seq + 1)),
            last_seq + 1, term=term)
        engine.attach_wal(writer)
    return engine, RecoveryInfo(snapshot=manifest["snapshot"],
                                wal_seq=wal_seq, replayed=replayed,
                                last_seq=last_seq,
                                truncated_bytes=truncated,
                                term=term)


def ensure_attached(engine, directory: str) -> None:
    """Boot contract for serving: make ``engine`` durable into ``directory``.

    A fresh directory gets the initial snapshot and a WAL writer at seq 1;
    an engine already attached there (the ``open_engine`` path) is left as
    it is. A directory holding a manifest the engine did NOT come from is
    refused: re-initializing it would orphan acknowledged mutations.
    """
    os.makedirs(directory, exist_ok=True)
    wal = getattr(engine, "_wal", None)
    if wal is not None and (os.path.dirname(os.path.abspath(wal.path))
                            == os.path.abspath(directory)):
        return
    try:
        read_manifest(directory)
    except NoSnapshotError:
        manifest = save_snapshot(engine, directory)
        writer = wal_mod.WALWriter(
            os.path.join(directory, wal_mod.wal_name(1)), 1,
            term=int(manifest.get("term", 0)))
        engine.attach_wal(writer)
        return
    raise ValueError(
        f"{directory} already holds a durable index this engine did not "
        "come from — boot it with persist.open_engine(directory) so the "
        "WAL resumes where it left off")

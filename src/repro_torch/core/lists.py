"""Padded inverted-list storage (counterpart of ``repro.core.lists``).

Layout, byte for byte the reference's:
  codes: (nlist, cap, M//2) uint8   nibble-packed PQ codes, zero-padded,
                                    low nibble = even sub-space
  ids:   (nlist, cap)       int32   global vector ids, -1 = padding
  sizes: (nlist,)           int32   true occupancy per list (<= cap)
  attrs: (nlist, cap)       int32   optional per-row attribute, -1 = padding

Filter bitmaps are packed ``(nlist, W) u8`` with ``W = ceil(cap / 8)``;
bit ``j`` of word ``w`` is slot ``w*8 + j`` (LSB-first), 1 = the row passes.

Live mutation (the reference's invariants, derivable from ``ids`` and
``sizes`` alone): ``sizes[l]`` is the watermark, the slots ever written
this epoch, where appends go; a deleted row is a tombstone, ``ids`` (and
``attrs``) -1 inside the watermark with its stale code bytes left in
place; ``live_filter_bits`` packs ``ids >= 0``. ``tombstone_rows``,
``append_rows`` and ``compact_lists`` (at the same cap) write into the
given store's own tensors, which is how a serving engine keeps the
addresses its CUDA graphs read; clone a store first to keep it.

A store may carry leading shard dimensions (``(S, nlist, cap)`` ids); the
``nlist``/``cap`` properties read the trailing two dimensions so they hold
for such stacked stores too.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.device import resolve_device


class ListStore(NamedTuple):
    codes: torch.Tensor   # (..., nlist, cap, M//2) uint8
    ids: torch.Tensor     # (..., nlist, cap) int32, -1 = padding
    sizes: torch.Tensor   # (..., nlist) int32
    attrs: torch.Tensor | None = None

    @property
    def nlist(self) -> int:
        return self.ids.shape[-2]

    @property
    def cap(self) -> int:
        return self.ids.shape[-1]

    def gather(self, probe_ids: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
        """Probed lists as copies: probe_ids (..., P) -> codes (..., P, cap,
        M//2) u8 and ids (..., P, cap) i32. A negative probe yields a fully
        padded list: ids all -1 and codes all zero, so the scan does no work
        on another list's real codes."""
        valid = probe_ids >= 0
        safe = torch.clamp_min(probe_ids, 0).long()
        codes = torch.where(valid[..., None, None], self.codes[safe], 0)
        ids = torch.where(valid[..., None], self.ids[safe], -1)
        return codes, ids

    def gather_ids(self, probe_ids: torch.Tensor) -> torch.Tensor:
        """ids of the probed lists: probe_ids (..., P) -> (..., P, cap) i32;
        a negative probe yields a fully padded (-1) list."""
        got = self.ids[torch.clamp_min(probe_ids, 0).long()]
        return torch.where((probe_ids >= 0)[..., None], got, -1)

    def probed_sizes(self, probe_ids: torch.Tensor) -> torch.Tensor:
        """True occupancy of each probed list (0 for invalid probes)."""
        got = self.sizes[torch.clamp_min(probe_ids, 0).long()]
        return torch.where(probe_ids >= 0, got, 0)


def base_norms(base: torch.Tensor) -> torch.Tensor:
    """Per-row squared norms ``‖x‖²`` (N, D) -> (N,) f32: the same row-wise
    multiply + sum the re-rank distance uses for ``‖q‖²``."""
    return torch.sum(base * base, dim=-1)


def filter_words(cap: int) -> int:
    """Words per list of a packed filter bitmap: W = ceil(cap / 8)."""
    return -(-int(cap) // 8)


_BIT = 1 << np.arange(8)


def pack_filter_mask(mask: torch.Tensor) -> torch.Tensor:
    """Per-slot bool mask (..., cap) -> packed bitmap (..., W) u8
    (LSB-first; bits past ``cap`` in the last word are 0)."""
    cap = mask.shape[-1]
    m = mask.to(torch.int32)
    pad = (-cap) % 8
    if pad:
        m = torch.nn.functional.pad(m, (0, pad))
    m = m.reshape(*mask.shape[:-1], -1, 8)
    weights = torch.as_tensor(_BIT, dtype=torch.int32, device=mask.device)
    return torch.sum(m * weights, dim=-1).to(torch.uint8)


def unpack_filter_mask(bits: torch.Tensor, cap: int) -> torch.Tensor:
    """Inverse of ``pack_filter_mask``: (..., W) u8 -> (..., cap) bool."""
    shifts = torch.arange(8, dtype=torch.int32, device=bits.device)
    u = (bits.to(torch.int32)[..., None] >> shifts) & 1
    return u.reshape(*bits.shape[:-1], -1)[..., :cap].to(torch.bool)


def filter_from_attrs(store: ListStore, predicate) -> torch.Tensor:
    """Evaluate a per-row predicate over ``store.attrs`` into a packed
    bitmap: ``predicate`` maps the (nlist, cap) i32 attrs elementwise to
    bool; returns (nlist, W) u8. Padded slots (id -1) are forced to 0
    whatever the predicate says of the -1 attr sentinel."""
    if store.attrs is None:
        raise ValueError("ListStore holds no attrs column; build with "
                         "build_lists(..., attrs=...)")
    return pack_filter_mask(predicate(store.attrs) & (store.ids >= 0))


def filter_pass_sizes(store: ListStore, filter_bits: torch.Tensor
                      ) -> torch.Tensor:
    """Rows per list that pass the filter: (nlist, W) u8 -> (nlist,) i32.
    Bits at slots past ``sizes`` never count."""
    cap = store.cap
    m = unpack_filter_mask(filter_bits, cap)
    slot = torch.arange(cap, dtype=torch.int32, device=m.device)
    inside = slot < store.sizes[..., None]
    return torch.sum(m & inside, dim=-1, dtype=torch.int32)


def build_lists(assign: np.ndarray, packed_codes: np.ndarray, *, nlist: int,
                cap: int | None = None, ids: np.ndarray | None = None,
                attrs: np.ndarray | None = None,
                device: torch.device | str | None = None) -> ListStore:
    """Bucket packed codes into padded lists (host-side numpy, offline),
    onto ``device`` (None = the CUDA card; raises without one).

    Same result as the reference's row-by-row loop, vectorised: a stable
    argsort by list puts each list's rows in their original order, a row's
    slot is its rank inside its list, and rows ranked past ``cap`` are
    dropped (reflected in ``sizes``).
    """
    assign = np.asarray(assign, np.int64)
    packed = np.asarray(packed_codes, np.uint8)
    n, mh = packed.shape
    gids = (np.arange(n, dtype=np.int32) if ids is None
            else np.asarray(ids, np.int32))
    counts = np.bincount(assign, minlength=nlist)
    cap_ = int(cap or max(1, counts.max(initial=0)))
    order = np.argsort(assign, kind="stable")
    lists = assign[order]
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    rank = np.arange(n) - starts[lists]
    keep = rank < cap_
    li, si, src = lists[keep], rank[keep], order[keep]
    list_codes = np.zeros((nlist, cap_, mh), np.uint8)
    list_ids = np.full((nlist, cap_), -1, np.int32)
    list_codes[li, si] = packed[src]
    list_ids[li, si] = gids[src]
    list_attrs = None
    if attrs is not None:
        list_attrs = np.full((nlist, cap_), -1, np.int32)
        list_attrs[li, si] = np.asarray(attrs, np.int32)[src]
    return store_from_arrays(
        {"codes": list_codes, "ids": list_ids,
         "sizes": np.minimum(counts, cap_).astype(np.int32),
         **({} if list_attrs is None else {"attrs": list_attrs})},
        device=device)


def grow_cap(store: ListStore, new_cap: int) -> ListStore:
    """Pad every list with spare slots: cap -> ``new_cap`` (ids -1, codes 0,
    attrs -1); sizes are untouched, so scans see the same rows."""
    pad = new_cap - store.cap
    if pad < 0:
        raise ValueError(f"grow_cap: new_cap {new_cap} < current cap "
                         f"{store.cap}")
    if pad == 0:
        return store
    fpad = torch.nn.functional.pad
    return ListStore(
        codes=fpad(store.codes, (0, 0, 0, pad)),
        ids=fpad(store.ids, (0, pad), value=-1),
        sizes=store.sizes,
        attrs=None if store.attrs is None else fpad(store.attrs, (0, pad),
                                                    value=-1))


def locate_rows(store: ListStore) -> dict[int, tuple[int, int]]:
    """Host-side id -> (list, slot) map of every live row."""
    ids = store.ids.cpu().numpy()
    ls, ss = np.nonzero(ids >= 0)
    return {int(ids[l, s]): (int(l), int(s)) for l, s in zip(ls, ss)}


def live_counts(store: ListStore) -> torch.Tensor:
    """(nlist,) i32 rows per list that are live (id >= 0, inside the
    watermark)."""
    return torch.sum(store.ids >= 0, dim=-1, dtype=torch.int32)


def tombstone_counts(store: ListStore) -> torch.Tensor:
    """(nlist,) i32 tombstoned slots per list: watermark minus live rows."""
    return store.sizes - live_counts(store)


def live_filter_bits(store: ListStore) -> torch.Tensor:
    """Packed (nlist, W) u8 bitmap of the live rows: bit 1 exactly where
    ``ids >= 0``, so padding and tombstones are both 0. ANDed into a
    request's filter, it makes the scan treat tombstones as padding before
    its candidate selection."""
    return pack_filter_mask(store.ids >= 0)


def tombstone_rows(store: ListStore, list_ids: np.ndarray, slots: np.ndarray
                   ) -> ListStore:
    """Delete rows, in place: ids/attrs at each (list, slot) become -1.
    Codes and watermarks stay (a tombstone is masked by its id like padding
    and not reused until compaction). Returns the store."""
    dev = store.ids.device
    at = (torch.as_tensor(np.asarray(list_ids, np.int64), device=dev),
          torch.as_tensor(np.asarray(slots, np.int64), device=dev))
    minus = torch.tensor(-1, dtype=torch.int32, device=dev)
    store.ids.index_put_(at, minus)
    if store.attrs is not None:
        store.attrs.index_put_(at, minus)
    return store


def append_rows(store: ListStore, list_ids: np.ndarray, packed: np.ndarray,
                gids: np.ndarray, attrs: np.ndarray | None = None
                ) -> tuple[ListStore, np.ndarray]:
    """Append rows into spare slots at each target list's watermark, in
    place.

    list_ids (B,) target list per row; packed (B, M//2) u8 codes; gids (B,)
    i32 global ids; attrs optional (B,) i32 (-1 where absent; required to
    be absent when the store holds no attrs column). Returns (store, slots
    (B,) the rows landed in): slot = watermark + the row's rank among the
    batch's rows for its list, batch order. Raises, writing nothing, when a
    target list lacks spare capacity (compact or grow first).
    """
    list_ids = np.asarray(list_ids, np.int64)
    packed = np.asarray(packed, np.uint8)
    gids = np.asarray(gids, np.int32)
    b = list_ids.shape[0]
    sizes = store.sizes.cpu().numpy().astype(np.int64)
    order = np.argsort(list_ids, kind="stable")
    rank = np.empty(b, np.int64)
    sorted_lists = list_ids[order]
    rank[order] = np.arange(b) - np.searchsorted(sorted_lists, sorted_lists,
                                                 side="left")
    slots = sizes[list_ids] + rank
    if b and slots.max() >= store.cap:
        full = int(list_ids[slots.argmax()])
        raise ValueError(
            f"append_rows: list {full} is out of spare capacity "
            f"(cap={store.cap}); compact or grow_cap first")
    if store.attrs is None and attrs is not None:
        raise ValueError("append_rows: attrs given but the store holds no "
                         "attrs column (build with attrs=...)")
    dev = store.ids.device
    at = (torch.as_tensor(list_ids, device=dev),
          torch.as_tensor(slots, device=dev))
    store.codes.index_put_(at, torch.as_tensor(packed, device=dev))
    store.ids.index_put_(at, torch.as_tensor(gids, device=dev))
    counts = np.bincount(list_ids, minlength=store.nlist).astype(np.int32)
    store.sizes.add_(torch.as_tensor(counts, device=dev))
    if store.attrs is not None:
        avals = (np.full(b, -1, np.int32) if attrs is None
                 else np.asarray(attrs, np.int32))
        store.attrs.index_put_(at, torch.as_tensor(avals, device=dev))
    return store, slots.astype(np.int32)


def check_compact_cap(store: ListStore, cap: int,
                      counts: torch.Tensor | None = None) -> None:
    """Raise unless ``cap`` holds the store's largest live list
    (``counts``: its live counts, when the caller has them)."""
    counts = live_counts(store) if counts is None else counts
    most = int(counts.max()) if counts.numel() else 0
    if cap < most:
        raise ValueError(
            f"compact_lists: cap {cap} below the largest live list "
            f"({most} rows)")


def compact_lists(store: ListStore, cap: int | None = None) -> ListStore:
    """Rebuild every list without tombstones: survivors keep their relative
    slot order (a stable shift-down), watermarks become live counts, codes,
    ids and attrs past them are cleared (0, -1, -1), and ``cap`` may change
    (it must hold the largest live list). At the same cap the store's
    tensors are rewritten in place and returned; another cap returns new
    tensors and leaves the store as it was.
    """
    live = store.ids >= 0
    counts = torch.sum(live, dim=-1, dtype=torch.int32)
    old_cap = store.cap
    new_cap = int(cap if cap is not None else old_cap)
    check_compact_cap(store, new_cap, counts)
    # live slots first, each group in slot order
    order = torch.sort((~live).to(torch.uint8), dim=-1, stable=True).indices
    keep = (torch.arange(old_cap, device=live.device)
            < counts[..., None])

    def shift(x, fill):
        got = torch.gather(x, 1, order[..., None].expand_as(x)
                           if x.ndim == 3 else order)
        got = torch.where(keep[..., None] if x.ndim == 3 else keep, got,
                          fill)
        if new_cap <= old_cap:
            return got[:, :new_cap]
        pad = (0, 0, 0, new_cap - old_cap) if x.ndim == 3 else (
            0, new_cap - old_cap)
        return torch.nn.functional.pad(got, pad, value=fill)

    fresh = ListStore(
        codes=shift(store.codes, 0), ids=shift(store.ids, -1), sizes=counts,
        attrs=None if store.attrs is None else shift(store.attrs, -1))
    if new_cap != old_cap:
        return ListStore(*(None if t is None else t.contiguous()
                           for t in fresh))
    for dst, src in zip(store, fresh):
        if dst is not None:
            dst.copy_(src)
    return store


def store_arrays(store: ListStore) -> dict[str, np.ndarray]:
    """The store as plain host arrays (the interchange format of
    ``repro.core.lists.store_arrays``); ``attrs`` is absent when unused."""
    out = {"codes": store.codes.cpu().numpy(),
           "ids": store.ids.cpu().numpy(),
           "sizes": store.sizes.cpu().numpy()}
    if store.attrs is not None:
        out["attrs"] = store.attrs.cpu().numpy()
    return out


def store_from_arrays(arrays: dict[str, np.ndarray], *,
                      device: torch.device | str | None = None) -> ListStore:
    """Inverse of ``store_arrays``, onto ``device`` (None = the CUDA card;
    raises without one)."""
    device = resolve_device(device)

    def t(key, dtype):
        return torch.from_numpy(np.array(arrays[key], dtype)).to(device)
    return ListStore(codes=t("codes", np.uint8), ids=t("ids", np.int32),
                     sizes=t("sizes", np.int32),
                     attrs=t("attrs", np.int32) if "attrs" in arrays else None)


# ---------------------------------------------------------------------------
# shard partitioning (shard j owns lists j, j+S, j+2S, ...)
# ---------------------------------------------------------------------------

def round_robin_perm(nlist: int, num_shards: int) -> np.ndarray:
    """The list permutation ``partition_lists`` applies: shard j owns lists
    j, j+S, j+2S, ... of the (padded to S*L) id space. Exposed so that
    per-request sidecars (filter bitmaps, namespace rows) are sharded the
    same way as a store partitioned earlier."""
    s = int(num_shards)
    l = -(-int(nlist) // s)
    return np.arange(s * l).reshape(l, s).T.reshape(-1)


def round_robin_rows(x: torch.Tensor, num_shards: int, fill) -> torch.Tensor:
    """Pad a per-list tensor (nlist, ...) to S*L lists with ``fill`` and
    lay it out (S, L, ...) in round-robin order."""
    nlist = x.shape[0]
    s = int(num_shards)
    l = -(-nlist // s)
    if s * l > nlist:
        x = torch.cat([x, x.new_full((s * l - nlist,) + tuple(x.shape[1:]),
                                     fill)])
    perm = torch.as_tensor(round_robin_perm(nlist, s), device=x.device)
    return x[perm].reshape((s, l) + tuple(x.shape[1:]))


def partition_lists(store: ListStore, centroids: torch.Tensor,
                    num_shards: int
                    ) -> tuple[torch.Tensor, ListStore, torch.Tensor]:
    """Round-robin partition of the lists into shards.

    Returns (centroids (S, L, D), a ListStore with a leading shard
    dimension S, real (S, L) bool), L = ceil(nlist / S). Padding lists
    (False in ``real``) get a far-away centroid (1e30 in every coordinate),
    size 0 and all -1 ids, so every shard has the same shapes. ids stay
    global.
    """
    nlist = store.nlist
    s = int(num_shards)
    real = torch.as_tensor(round_robin_perm(nlist, s) < nlist,
                           device=store.ids.device).reshape(s, -1)
    return (round_robin_rows(centroids.float(), s, 1e30),
            ListStore(codes=round_robin_rows(store.codes, s, 0),
                      ids=round_robin_rows(store.ids, s, -1),
                      sizes=round_robin_rows(store.sizes, s, 0),
                      attrs=None if store.attrs is None
                      else round_robin_rows(store.attrs, s, -1)),
            real)


def partition_filter(filter_bits: torch.Tensor, num_shards: int
                     ) -> torch.Tensor:
    """Shard a packed (nlist, W) u8 filter bitmap over global list ids as
    ``partition_lists`` shards the lists: (S, L, W), padding lists all
    zero (nothing passes)."""
    return round_robin_rows(filter_bits, num_shards, 0)


def pack_local_rows(ids_s: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                               torch.Tensor]:
    """Shard-local base rows for a sharded store's ids (S, L, cap): each
    shard's valid slots get rows 0, 1, ... in order of appearance (list by
    list, slot by slot). Returns (local ids (S, L, cap) i32, -1 where ids
    is -1; the shard and the row of each valid slot in that order, both
    (V,) int64; rows each shard needs, (S,) int64)."""
    s = ids_s.shape[0]
    mask = ids_s.reshape(s, -1) >= 0
    rank = torch.cumsum(mask, dim=1) - 1
    local = torch.where(mask, rank, -1).to(torch.int32)
    js, ps = torch.nonzero(mask, as_tuple=True)
    return (local.reshape(ids_s.shape), js, rank[js, ps],
            torch.sum(mask, dim=1))


def partition_base(lists_s: ListStore, base: torch.Tensor,
                   norms: torch.Tensor | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                              torch.Tensor]:
    """Per-shard base slices and the id -> row remap of a sharded re-rank.

    lists_s: a store with a leading shard dimension S (``partition_lists``,
    ids global); base: (N, D) f32; ``norms``: its (N,) ``base_norms`` when
    the caller holds them (else derived here). Returns base_s (S, R, D) f32
    (each shard's rows in order of appearance, zero padded), gids_s (S, R)
    i32 (global id of each local row, -1 = padding), local_ids (S, L, cap)
    i32 (``lists_s.ids`` remapped to local rows) and norms_s (S, R) f32
    (the rows' norms gathered, 0 at padding). R is the most rows any shard
    holds (at least 1).
    """
    ids = lists_s.ids
    s = ids.shape[0]
    local, js, rows, counts = pack_local_rows(ids)
    r_cap = max(1, int(counts.max()))
    flat = ids.reshape(s, -1)
    gid = flat[flat >= 0].long()
    base_s = base.new_zeros((s, r_cap, base.shape[1]))
    base_s[js, rows] = base[gid]
    gids_s = torch.full((s, r_cap), -1, dtype=torch.int32, device=ids.device)
    gids_s[js, rows] = gid.to(torch.int32)
    norms_s = base.new_zeros((s, r_cap))
    norms_s[js, rows] = (base_norms(base) if norms is None else norms)[gid]
    return base_s, gids_s, local, norms_s

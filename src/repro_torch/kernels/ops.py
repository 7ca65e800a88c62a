"""Dispatch wrappers around the port's kernels, plus autotuning
(counterpart of ``repro.kernels.ops``).

Handles tile choice, padding and the impl registries -- one source of
truth, everything else derives from them:

  ``GROUPED_IMPLS``  concrete grouped-scan formulations ('ref' plain torch
                     gather / 'select' register-shuffle kernel K5 / 'mxu'
                     tensor-core one-hot kernel K6 / 'stream' gather-free
                     in-place kernel K3);
  ``IMPLS``          the flat (shared-database) scan: 'ref' / 'select'
                     (K7a) / 'mxu' (K7b); ``fastscan_blockmin`` is K7c;
  ``SCAN_IMPLS``     what callers may request: GROUPED_IMPLS + 'auto';
  ``RERANK_CONCRETE`` / ``RERANK_IMPLS``  the exact re-rank's 'gathered'
                     (plain torch) and 'stream' (kernel K2), + 'auto'.

``impl='auto'`` resolves to a concrete (impl, tile) by a one-time timed
micro-sweep per ``('scan', backend, interpret, G, cap, M, nlist,
probe_fill)`` or ``('rerank', backend, interpret, Q, R, D, k, N)``
signature, cached process-wide (``resolve_grouped_impl``,
``resolve_rerank_impl``). ``backend`` is the device type the sweep timed on
('cuda' or 'cpu') and ``interpret`` is always False in the port, so a
verdict file carries across to and from the reference
(``save_autotune_cache`` / ``load_autotune_cache``, schema v3, v1/v2 files
migrated). The sweep drops a candidate only when its wrapper rejects the
shape with ``ValueError`` before any launch; a kernel that fails to build
or launch raises.
"""
from __future__ import annotations

import functools
import json
import os
import threading
import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import topk as topk_mod
from repro_torch.core.lists import ListStore
from repro_torch.device import resolve_device
from repro_torch.kernels import blockmin_kernel as bk
from repro_torch.kernels import fastscan_kernel as fk
from repro_torch.kernels import mxu_flat_kernel as mfk
from repro_torch.kernels import mxu_kernel as mk
from repro_torch.kernels import pq_decode_kernel as pqk
from repro_torch.kernels import ref as ref_mod
from repro_torch.kernels import rerank_kernel as rk
from repro_torch.kernels import select_flat_kernel as sfk
from repro_torch.kernels import select_kernel as sk
from repro_torch.kernels import stream_grouped_kernel as sgk
from repro_torch.kernels import stream_prune_kernel as spk

# every kernel's module (each counts its launches in ``launches``)
KERNEL_MODULES = (fk, rk, sgk, spk, sk, mk, sfk, mfk, bk, pqk)

GROUPED_IMPLS = ("ref", "select", "mxu", "stream")
IMPLS = ("ref", "select", "mxu")
SCAN_IMPLS = GROUPED_IMPLS + ("auto",)
RERANK_CONCRETE = ("gathered", "stream")
RERANK_IMPLS = RERANK_CONCRETE + ("auto",)


def _auto_tile(size: int, cap: int) -> int:
    """Largest power-of-two tile <= cap covering size (min 8)."""
    pow2 = 1 << max(size - 1, 1).bit_length()
    return max(8, min(cap, pow2))


def _stream_tile(cap: int, tile_n: int = 0) -> int:
    """A cap tile that DIVIDES cap (the store is scanned in place): honour
    ``tile_n`` when it divides cap, else the largest power-of-two divisor
    <= TILE_N (floor 8), else cap itself (one tile per list)."""
    if tile_n and cap % tile_n == 0:
        return tile_n
    t = fk.TILE_N
    while t >= 8:
        if cap % t == 0:
            return t
        t //= 2
    return cap


def _rerank_tile(r: int, tile_r: int = 0) -> int:
    """Candidate-chunk size: an explicit ``tile_r``, else the smallest power
    of two >= min(r, TILE_R) (floor 8); ids are padded with -1."""
    if tile_r:
        return tile_r
    return max(8, min(rk.TILE_R, 1 << max(r - 1, 1).bit_length()))


def _pad_to(x: torch.Tensor, dim: int, mult: int, value: int = 0
            ) -> torch.Tensor:
    pad = (-x.shape[dim]) % mult
    if pad == 0:
        return x
    widths = [0, 0] * (x.ndim - dim % x.ndim)
    widths[-1] = pad
    return torch.nn.functional.pad(x, widths, value=value)


# ---------------------------------------------------------------------------
# flat scan (one code database shared by every query)
# ---------------------------------------------------------------------------

def fastscan_distances(table_q8: torch.Tensor, packed_codes: torch.Tensor, *,
                       impl: str = "mxu") -> torch.Tensor:
    """Flat ADC accumulation: (Q, M, 16) u8 x (N, M//2) u8 -> (Q, N) i32.

    impl: 'ref' (plain torch gather) | 'select' (K7a, register shuffles,
    paper-faithful) | 'mxu' (K7b, one-hot product on the tensor cores).
    All bit-identical. The kernels take any Q and N (they mask rows and
    queries past the ends), so nothing is padded, unlike the reference,
    whose TPU tiles need it.
    """
    if table_q8.ndim == 2:
        table_q8 = table_q8[None]
    k = table_q8.shape[-1]
    if k != 16:
        raise ValueError(f"4-bit PQ requires K=16, got {k}")
    if impl == "ref":
        return ref_mod.fastscan_distances_ref(table_q8, packed_codes)
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; want one of {IMPLS}")
    fn = (sfk.fastscan_select_tree if impl == "select"
          else mfk.fastscan_onehot_mxu)
    return fn(table_q8.contiguous(), packed_codes.contiguous())


def fastscan_blockmin(table_q8: torch.Tensor, packed_codes: torch.Tensor, *,
                      block: int = 1024) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused flat ADC + per-block min and argmin (K7c).

    Returns (min_dists (Q, ceil(N/block)) i32, global argmin ids), the
    lowest id among equal sums. As in the reference, N is padded to a
    multiple of ``block`` with code 15 in every sub-space (bytes 0xFF): a
    padded row can win the ragged last block, and its id is then >= N --
    callers who need exact semantics mask on ``id < N``.
    """
    if table_q8.ndim == 2:
        table_q8 = table_q8[None]
    if block < 1:
        raise ValueError(f"block={block} must be >= 1")
    codes_p = _pad_to(packed_codes, 0, block, value=0xFF).contiguous()
    return bk.fastscan_blockmin(table_q8.contiguous(), codes_p, tile_n=block)


# ---------------------------------------------------------------------------
# grouped scan (the IVF hot path)
# ---------------------------------------------------------------------------

def _fastscan_grouped_kernel(table_q8: torch.Tensor, codes: torch.Tensor, *,
                             impl: str, tile_n: int) -> torch.Tensor:
    """'select' (K5) / 'mxu' (K6) half of the grouped dispatch: pads cap up
    to the tile (the copy is the caller's, so padding is free to add)."""
    cap = codes.shape[1]
    tn = tile_n or _auto_tile(cap, fk.TILE_N)
    codes_p = _pad_to(codes, 1, tn).contiguous()
    fn = (sk.fastscan_select_tree_grouped if impl == "select"
          else mk.fastscan_onehot_mxu_grouped)
    return fn(table_q8.contiguous(), codes_p, tile_n=tn)[:, :cap]


def _fastscan_grouped_stream(table_q8: torch.Tensor, codes: torch.Tensor, *,
                             tile_n: int) -> torch.Tensor:
    """The stream impl (K3) under the gathered calling convention: the
    (G, cap, M//2) copy is treated as a store of G lists probed by
    arange(G). Exists so 'stream' fits the same registry and sweep as the
    gathered impls; the gather-free payoff comes from
    ``fastscan_stream_grouped`` on the real ListStore."""
    g, cap = codes.shape[0], codes.shape[1]
    tn = tile_n if (tile_n and cap % tile_n == 0) else _auto_tile(cap,
                                                                  fk.TILE_N)
    codes_p = _pad_to(codes, 1, tn).contiguous()
    probes = torch.arange(g, dtype=torch.int32, device=codes.device)
    return sgk.fastscan_stream_grouped(table_q8.contiguous(), codes_p, probes,
                                       tile_n=tn)[:, :cap]


def fastscan_grouped(table_q8: torch.Tensor, codes: torch.Tensor, *,
                     impl: str = "ref", tile_n: int = 0) -> torch.Tensor:
    """Grouped ADC for gathered IVF lists: (G, M, 16) u8 x (G, cap, M//2) u8
    -> (G, cap) i32. Group g = one (query, probed-list) pair.

    impl: 'ref' (plain torch gather) | 'select' (K5) | 'mxu' (K6) |
    'stream' (K3 over the copy as a G-list store) | 'auto' (timed sweep
    picks the (impl, tile) pair per signature; an explicit ``tile_n`` is
    ignored under 'auto', since the sweep timed pairs). Bit-identical.
    """
    g, m, k = table_q8.shape
    cap = codes.shape[1]
    if k != 16:
        raise ValueError(f"4-bit PQ requires K=16, got {k}")
    if impl not in SCAN_IMPLS:
        raise ValueError(f"unknown grouped impl {impl!r}; "
                         f"want one of {SCAN_IMPLS}")
    if impl == "auto":
        tuned = resolve_grouped_impl(g, cap, m, device=table_q8.device)
        impl, tile_n = tuned.impl, tuned.tile_n
    if impl == "ref":
        return ref_mod.fastscan_grouped_ref(table_q8, codes)
    if impl == "stream":
        return _fastscan_grouped_stream(table_q8, codes, tile_n=tile_n)
    return _fastscan_grouped_kernel(table_q8, codes, impl=impl,
                                    tile_n=tile_n)


def resolve_scan_impl(impl: str, g: int, cap: int, m: int, *,
                      nlist: int | None = None, probe_fill: float = 1.0,
                      device: str | torch.device | None = None
                      ) -> tuple[str, int]:
    """Resolve a requested scan impl to a concrete ``(impl, tile_n)``.

    Concrete impls pass through with tile 0 (shape-fit default); 'auto'
    consults the autotune table, which may pick 'stream' so that callers
    holding the codes in place route to the gather-free path; they pass
    their store's ``nlist``. ``probe_fill`` is the expected fraction of
    valid probe slots (< 1 under the margin policy, whose -1 slots the
    stream kernels skip); ``device`` is where the sweep times.
    """
    if impl not in SCAN_IMPLS:
        raise ValueError(f"unknown grouped impl {impl!r}; "
                         f"want one of {SCAN_IMPLS}")
    if impl != "auto":
        return impl, 0
    tuned = resolve_grouped_impl(g, cap, m, nlist=nlist,
                                 probe_fill=probe_fill, device=device)
    return tuned.impl, tuned.tile_n


def resolve_rerank_dispatch(impl: str, q: int, r: int, d: int, k: int,
                            n: int, *,
                            device: str | torch.device | None = None
                            ) -> tuple[str, int]:
    """Resolve a requested re-rank impl to a concrete ``(impl, tile_r)``:
    concrete impls pass through with tile 0, 'auto' consults the autotune
    table (``resolve_rerank_impl``)."""
    if impl not in RERANK_IMPLS:
        raise ValueError(f"unknown rerank impl {impl!r}; "
                         f"want one of {RERANK_IMPLS}")
    if impl != "auto":
        return impl, 0
    tuned = resolve_rerank_impl(q, r, d, k, n, device=device)
    return tuned.impl, tuned.tile_n


def fastscan_stream_grouped(table_q8: torch.Tensor, list_codes: torch.Tensor,
                            probe_ids: torch.Tensor, *, tile_n: int = 0
                            ) -> torch.Tensor:
    """Gather-free grouped ADC over an in-place ListStore (K3): (G, M, 16)
    u8 x (nlist, cap, M//2) u8 + (G,) probe ids (-1 = none, zeros out) ->
    (G, cap) i32, equal at every slot of a valid probe to
    ``fastscan_grouped(table, list_codes[probe_ids])``."""
    tn = _stream_tile(list_codes.shape[1], tile_n)
    return sgk.fastscan_stream_grouped(
        table_q8.contiguous(), list_codes,
        probe_ids.to(torch.int32).contiguous(), tile_n=tn)


def fastscan_stream_topk(table_q8: torch.Tensor, list_codes: torch.Tensor,
                         probe_ids: torch.Tensor, sizes: torch.Tensor, *,
                         keep: int, tile_n: int = 0,
                         filter_bits: torch.Tensor | None = None,
                         early_exit: bool = False,
                         groups_per_query: int = 0,
                         scales: torch.Tensor | None = None,
                         biases: torch.Tensor | None = None
                         ) -> tuple[torch.Tensor, ...]:
    """Gather-free scan + fused candidate reduction over an in-place store.

    Each cap tile keeps its ``kc = max(1, min(keep, tile))`` smallest
    entries, so any final selection of <= ``keep`` candidates per query is
    exact. ``filter_bits`` (nlist, W) u8 masks rows whose bit is 0 before
    selection; the kernels read it in place by list id. Returns
    (vals (G, n_tiles, kc) i32, slots (G, n_tiles, kc) i32, -1 = absent).

    With ``early_exit`` (plus ``groups_per_query`` and the per-group
    dequantization ``scales``/``biases``, (G,) f32) the scan prunes tiles
    whose lower bound cannot beat the query's running kc-th best (K4), and
    a third array ``skipped`` (G, n_tiles) i32 is returned. Pruning is
    armed only when ``kc == keep`` and ``groups_per_query`` divides G;
    otherwise K1 runs and ``skipped`` is all zeros.
    """
    cap = list_codes.shape[1]
    tn = _stream_tile(cap, tile_n)
    kc = max(1, min(keep, tn))
    table_q8 = table_q8.contiguous()
    probes = probe_ids.to(torch.int32).contiguous()
    sizes = sizes.to(torch.int32).contiguous()
    fb = None if filter_bits is None else filter_bits.to(torch.uint8).contiguous()
    if not early_exit:
        return fk.fastscan_stream_topk_grouped(
            table_q8, list_codes, probes, sizes, kc=kc, tile_n=tn,
            filter_bits=fb)
    if scales is None or biases is None:
        raise ValueError("early_exit requires the per-group dequantization "
                         "affine (scales, biases)")
    g = table_q8.shape[0]
    if kc == keep and groups_per_query > 0 and g % groups_per_query == 0:
        scales = scales.to(torch.float32).contiguous()
        biases = biases.to(torch.float32).contiguous()
        # admissible per-group lower bound: the smallest possible ADC sum,
        # dequantized with the group's own affine (two rounded ops, as the
        # host dequantizes the emitted candidates)
        acc_min = torch.sum(torch.amin(table_q8, dim=-1), dim=-1,
                            dtype=torch.int32)
        bounds = scales * acc_min.float() + biases
        return spk.fastscan_stream_topk_prune(
            table_q8, list_codes, probes, sizes, bounds, scales, biases,
            kc=kc, tile_n=tn, groups_per_query=groups_per_query,
            filter_bits=fb)
    vals, slots = fk.fastscan_stream_topk_grouped(
        table_q8, list_codes, probes, sizes, kc=kc, tile_n=tn,
        filter_bits=fb)
    return vals, slots, torch.zeros(vals.shape[:2], dtype=torch.int32,
                                    device=vals.device)


def rerank_stream_topk(base: torch.Tensor, norms: torch.Tensor,
                       q: torch.Tensor, cand_ids: torch.Tensor, *, k: int,
                       tile_r: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """Gather-free exact re-rank over the in-place base.

    base (N, D) f32; norms (N,) f32 = ``core.lists.base_norms(base)``;
    q (Q, D) f32; cand_ids (Q, R) i32, -1 = padding. Returns
    (vals (Q, k) f32 ascending, ids (Q, k) i32, -1 = absent).
    """
    qq, r = cand_ids.shape
    tr = _rerank_tile(r, tile_r)
    cand_p = _pad_to(cand_ids.to(torch.int32), 1, tr, value=-1).contiguous()
    # only the candidates' norms are gathered up front: (Q, Rp) f32
    xn = norms[torch.clamp_min(cand_p, 0).long()].contiguous()
    vals, pos = rk.rerank_stream_topk(base, q.contiguous(), cand_p, xn, k=k,
                                      tile_r=tr)
    return vals, topk_mod.gather_ids(cand_p, pos)


# ---------------------------------------------------------------------------
# autotuning
# ---------------------------------------------------------------------------

class TunedScan(NamedTuple):
    """Autotune verdict for one scan/re-rank shape signature."""

    impl: str          # winning concrete impl (GROUPED_IMPLS / RERANK_CONCRETE)
    tile_n: int        # winning tile (0 = impl has no tiling knob)
    timings_us: tuple  # ((f"{impl}@{tile}", median_us), ...) -- full sweep


_AUTOTUNE_CACHE: dict[tuple, TunedScan] = {}
# serializes first resolutions: without it, two threads racing on the same
# signature would pay the sweep twice and could cache divergent verdicts
_AUTOTUNE_LOCK = threading.Lock()


# The candidate budget the scan sweep selects for each group: a 'stream'
# candidate's kc = min(_SWEEP_KEEP, tile), and the selection every
# candidate's pool goes through; the r*k of the serving default (k = 10,
# rerank_mult = 4). The verdict key holds no budget, so one stand-in serves
# every caller of a signature.
_SWEEP_KEEP = 40


def _grouped_tile_candidates(cap: int) -> tuple[int, ...]:
    """Cap-tile sizes worth timing: the shape-fit auto tile plus smaller
    power-of-two tiles."""
    fit = _auto_tile(cap, fk.TILE_N)
    cands = {fit}
    for t in (128, 512):
        if t < fit:
            cands.add(t)
    return tuple(sorted(cands))


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _median_time_us(fn, device: torch.device, iters: int = 3) -> float:
    """Median wall time of ``fn`` in microseconds after one warm-up call;
    on the card each timed call is bracketed by synchronizations, so it
    measures the kernels and not their enqueue."""
    fn()
    _synchronize(device)
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        _synchronize(device)
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2] * 1e6


def _resolve_cached(sig: tuple, sweep_fn, *args) -> TunedScan:
    """Shared resolve-or-sweep path of the scan and re-rank autotuners: one
    sweep per signature per process. (The reference runs the sweep on a
    worker thread to escape an ambient jax trace; torch runs eagerly, so
    it runs here, under the lock.) A miss while a CUDA stream is capturing
    a graph raises: the sweep synchronizes the card, which a capture
    cannot hold, so every verdict is resolved before capture."""
    hit = _AUTOTUNE_CACHE.get(sig)
    if hit is not None:
        return hit
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            f"autotune signature {sig} was not resolved before CUDA graph "
            "capture; run the pipeline eagerly once first")
    with _AUTOTUNE_LOCK:
        hit = _AUTOTUNE_CACHE.get(sig)  # racing thread may have resolved it
        if hit is not None:
            return hit
        tuned = sweep_fn(*args)
        _AUTOTUNE_CACHE[sig] = tuned
    return tuned


def _sweep_verdict(sweep: list, what: str) -> TunedScan:
    if not sweep:
        raise RuntimeError(f"autotune sweep produced no working candidate "
                           f"at {what}")
    best = min(sweep, key=lambda rec: rec[2])
    return TunedScan(impl=best[0], tile_n=best[1],
                     timings_us=tuple((f"{i}@{tn}", us)
                                      for i, tn, us in sweep))


def _time_candidates(cands, device: torch.device) -> list:
    """Time each ``(impl, tile, fn)``; a ``ValueError`` is the wrapper
    rejecting the shape before any launch and drops the candidate, any
    other exception (a build or launch failure) propagates."""
    sweep = []
    for impl, tile, fn in cands:
        try:
            us = _median_time_us(fn, device)
        except ValueError:
            continue
        sweep.append((impl, tile, us))
    return sweep


def resolve_grouped_impl(g: int, cap: int, m: int, *, nlist: int | None = None,
                         probe_fill: float = 1.0,
                         device: str | torch.device | None = None
                         ) -> TunedScan:
    """Resolve ``impl='auto'`` for the grouped scan at one shape signature.

    Times every concrete impl (x its tile candidates) on seeded synthetic
    data of the workload shape on ``device`` (None = the CUDA card) and
    caches the winner per ``('scan', device type, False, G, cap, M, nlist,
    probe_fill)``. Each candidate is timed as its whole stage, from the
    store to each group's ``_SWEEP_KEEP`` best candidates
    (``_sweep_stage``): the gathered impls with their ``ListStore.gather``,
    a 'stream' candidate as the per-tile top-kc scan (K1) at its tile;
    ``nlist`` is the size of the store (None = the gathered convention's
    G-list store);
    ``probe_fill`` in (0, 1] masks ``1 - probe_fill`` of the sweep's probes
    to -1, the workload an adaptive-nprobe policy presents.
    """
    dev = resolve_device(device)
    nl = int(g if nlist is None else nlist)
    fill = round(float(probe_fill), 4)
    if not 0.0 < fill <= 1.0:
        raise ValueError(f"probe_fill must be in (0, 1], got {probe_fill}")
    sig = ("scan", dev.type, False, int(g), int(cap), int(m), nl, fill)
    return _resolve_cached(sig, _run_grouped_sweep, int(g), int(cap), int(m),
                           nl, fill, dev)


def _sweep_stage(table: torch.Tensor, lists: ListStore, probes: torch.Tensor,
                 impl: str, tile_n: int, keep: int):
    """One scan candidate's whole stage, from the store to each group's
    ``keep`` best candidates: a gathered impl's ``ListStore.gather`` and
    full-pool scan, or the per-tile top-kc scan (K1) over the lists in
    place that a 'stream' verdict runs (K4 with early exit); then the same
    selection over the pool either leaves."""
    if impl == "stream":
        acc, pos = fastscan_stream_topk(table, lists.codes, probes,
                                        lists.sizes, keep=keep,
                                        tile_n=tile_n)
        valid = pos >= 0
    else:
        codes, ids = lists.gather(probes)
        acc = fastscan_grouped(table, codes, impl=impl, tile_n=tile_n)
        valid = ids >= 0
    g = acc.shape[0]
    return topk_mod.masked_topk(acc.reshape(g, -1).float(),
                                valid.reshape(g, -1), keep)


def _run_grouped_sweep(g: int, cap: int, m: int, nlist: int, fill: float,
                       dev: torch.device) -> TunedScan:
    rng = np.random.default_rng(0)
    table = rng.integers(0, 256, (g, m, 16), dtype=np.uint8)
    # an nlist-sized store of full lists with random probes: the stream impl
    # scans it in place, the gathered impls gather the probed lists first
    store = rng.integers(0, 256, (nlist, cap, m // 2), dtype=np.uint8)
    probes = rng.integers(0, nlist, (g,), dtype=np.int32)
    if fill < 1.0:
        # an adaptive-probe mix: a deterministic 1-fill share of the slots
        # pruned to -1, spread evenly rather than a dead prefix
        n_prune = min(g - 1, int(round(g * (1.0 - fill))))
        if n_prune > 0:
            probes[np.linspace(0, g - 1, n_prune).astype(np.int64)] = -1
    table, store, probes = (torch.from_numpy(a).to(dev)
                            for a in (table, store, probes))
    lists = ListStore(
        codes=store,
        ids=torch.arange(nlist * cap, dtype=torch.int32,
                         device=dev).reshape(nlist, cap),
        sizes=torch.full((nlist,), cap, dtype=torch.int32, device=dev))
    keep = min(_SWEEP_KEEP, cap)
    cands = []
    for impl in GROUPED_IMPLS:
        if impl == "ref":
            tiles = (0,)
        elif impl == "stream":
            # in place, so only cap-dividing tiles are realizable: time
            # exactly the (impl, tile) pair that would execute
            tiles = tuple(sorted({_stream_tile(cap, t)
                                  for t in _grouped_tile_candidates(cap)}))
        else:
            tiles = _grouped_tile_candidates(cap)
        for tn in tiles:
            cands.append((impl, tn, functools.partial(
                _sweep_stage, table, lists, probes, impl, tn, keep)))
    return _sweep_verdict(_time_candidates(cands, dev),
                          f"(G={g}, cap={cap}, M={m})")


# Default cap on the synthetic base built for the re-rank sweep (the real N
# stays in the verdict key); ``REPRO_RERANK_SWEEP_N_CAP`` or the
# ``sweep_n_cap`` argument raise it, as in the reference.
_RERANK_SWEEP_N_CAP = 65536


def _rerank_sweep_n_cap() -> int:
    """Effective sweep cap: ``REPRO_RERANK_SWEEP_N_CAP`` (>= 1) or the
    default; read at resolve time."""
    raw = os.environ.get("REPRO_RERANK_SWEEP_N_CAP", "")
    try:
        cap = int(raw)
    except ValueError:
        return _RERANK_SWEEP_N_CAP
    return cap if cap >= 1 else _RERANK_SWEEP_N_CAP


def resolve_rerank_impl(q: int, r: int, d: int, k: int, n: int, *,
                        sweep_n_cap: int | None = None,
                        device: str | torch.device | None = None
                        ) -> TunedScan:
    """Resolve ``rerank_impl='auto'`` at one (Q, R, D, k, N) signature.

    Times the gathered norms+GEMM re-rank against the stream kernel (x its
    chunk tiles) on synthetic data of the workload shape on ``device``
    (base rows capped at ``sweep_n_cap``, else the env var, else
    ``_RERANK_SWEEP_N_CAP``), cached per ``('rerank', device type, False,
    Q, R, D, k, N)`` in the same table as the scan verdicts. The cap shapes
    only the stand-in, never the key.
    """
    dev = resolve_device(device)
    cap = (_rerank_sweep_n_cap() if sweep_n_cap is None
           else max(1, int(sweep_n_cap)))
    sig = ("rerank", dev.type, False, int(q), int(r), int(d), int(k), int(n))
    return _resolve_cached(sig, _run_rerank_sweep, int(q), int(r), int(d),
                           int(k), int(n), cap, dev)


def _rerank_tile_candidates(r: int) -> tuple[int, ...]:
    fit = _rerank_tile(r)
    return tuple(sorted({fit} | {t for t in (16, 32) if t < fit}))


def _run_rerank_sweep(q: int, r: int, d: int, k: int, n: int, n_cap: int,
                      dev: torch.device) -> TunedScan:
    from repro_torch.engine import rerank as rerank_mod  # engine -> ops

    rng = np.random.default_rng(0)
    n_sweep = max(r, min(n, n_cap))
    base = torch.from_numpy(rng.standard_normal((n_sweep, d),
                                                dtype=np.float32)).to(dev)
    norms = torch.sum(base * base, dim=-1)
    queries = torch.from_numpy(rng.standard_normal((q, d),
                                                   dtype=np.float32)).to(dev)
    cand = torch.from_numpy(rng.integers(0, n_sweep, (q, r),
                                         dtype=np.int32)).to(dev)
    cands = [("gathered", 0, functools.partial(
        rerank_mod.exact_rerank, base, queries, cand, k, norms=norms))]
    for tr in _rerank_tile_candidates(r):
        cands.append(("stream", tr, functools.partial(
            rerank_stream_topk, base, norms, queries, cand, k=k, tile_r=tr)))
    return _sweep_verdict(_time_candidates(cands, dev),
                          f"(Q={q}, R={r}, D={d}, k={k})")


def autotune_cache() -> dict[tuple, TunedScan]:
    """Snapshot of the process-wide autotune cache (mutations don't stick)."""
    return dict(_AUTOTUNE_CACHE)


def autotune_cache_size() -> int:
    """Number of resolved signatures."""
    return len(_AUTOTUNE_CACHE)


def clear_autotune_cache(kind: str | None = None, *, nlist: int | None = None,
                         cap: int | None = None, n: int | None = None) -> int:
    """Drop resolved verdicts; with no arguments, all of them.

    ``kind`` restricts to 'scan' or 'rerank' keys; ``nlist``/``cap`` match
    only scan keys on those ListStore dimensions and ``n`` only rerank keys
    on the base-row count. Returns the number of entries dropped.
    """
    with _AUTOTUNE_LOCK:
        if kind is None and nlist is None and cap is None and n is None:
            dropped = len(_AUTOTUNE_CACHE)
            _AUTOTUNE_CACHE.clear()
            return dropped
        doomed = []
        for key in _AUTOTUNE_CACHE:
            if kind is not None and key[0] != kind:
                continue
            if key[0] == "scan":
                # ('scan', backend, interpret, G, cap, M, nlist, probe_fill)
                if n is not None:
                    continue
                if nlist is not None and key[6] != nlist:
                    continue
                if cap is not None and key[4] != cap:
                    continue
            else:
                # ('rerank', backend, interpret, Q, R, D, k, N)
                if nlist is not None or cap is not None:
                    continue
                if n is not None and key[7] != n:
                    continue
            doomed.append(key)
        for key in doomed:
            del _AUTOTUNE_CACHE[key]
        return len(doomed)


_AUTOTUNE_SCHEMA = "repro.autotune/v3"
_AUTOTUNE_SCHEMA_V2 = "repro.autotune/v2"
_AUTOTUNE_SCHEMA_V1 = "repro.autotune/v1"


def save_autotune_cache(path: str) -> int:
    """Write the resolved verdicts to JSON at ``path`` (the reference's
    schema v3: each entry has its ``kind`` and that kind's key fields).
    Returns the number of entries written."""
    with _AUTOTUNE_LOCK:
        snapshot = dict(_AUTOTUNE_CACHE)
    entries = []
    for key, t in snapshot.items():
        timings = [[name, us] for name, us in t.timings_us]
        if key[0] == "scan":
            _, b, i, g, c, m, nl, fill = key
            entries.append({"kind": "scan", "backend": b, "interpret": bool(i),
                            "g": g, "cap": c, "m": m, "nlist": nl,
                            "probe_fill": fill,
                            "impl": t.impl, "tile_n": t.tile_n,
                            "timings_us": timings})
        else:
            _, b, i, q, r, d, k, n = key
            entries.append({"kind": "rerank", "backend": b,
                            "interpret": bool(i), "q": q, "r": r, "d": d,
                            "k": k, "n": n, "impl": t.impl,
                            "tile_n": t.tile_n, "timings_us": timings})
    with open(path, "w") as f:
        json.dump({"schema": _AUTOTUNE_SCHEMA, "entries": entries}, f,
                  indent=2)
    return len(entries)


def load_autotune_cache(path: str) -> int:
    """Merge a ``save_autotune_cache`` file into the process-wide table.

    Returns the number of entries adopted. A missing file, another schema
    or malformed JSON loads nothing (0). v1 files (no ``kind``, no
    ``nlist``) re-key their scan verdicts to ``nlist=g``, and v1/v2 files
    (no ``probe_fill``) to ``probe_fill=1.0``, the sweeps they ran. Entries
    naming an unknown impl are skipped; verdicts already resolved in this
    process are kept.
    """
    if not os.path.exists(path):
        return 0
    try:
        with open(path) as f:
            data = json.load(f)
    except (OSError, json.JSONDecodeError):
        return 0
    if not isinstance(data, dict) or data.get("schema") not in (
            _AUTOTUNE_SCHEMA, _AUTOTUNE_SCHEMA_V2, _AUTOTUNE_SCHEMA_V1):
        return 0
    loaded = 0
    with _AUTOTUNE_LOCK:
        for e in data.get("entries", ()):
            try:
                kind = str(e.get("kind", "scan"))
                if kind == "scan":
                    g = int(e["g"])
                    key = ("scan", str(e["backend"]), bool(e["interpret"]),
                           g, int(e["cap"]), int(e["m"]),
                           int(e.get("nlist", g)),  # v1: the G-list store
                           round(float(e.get("probe_fill", 1.0)), 4))
                    known = GROUPED_IMPLS
                elif kind == "rerank":
                    key = ("rerank", str(e["backend"]), bool(e["interpret"]),
                           int(e["q"]), int(e["r"]), int(e["d"]),
                           int(e["k"]), int(e["n"]))
                    known = RERANK_CONCRETE
                else:
                    continue
                tuned = TunedScan(
                    impl=str(e["impl"]), tile_n=int(e["tile_n"]),
                    timings_us=tuple((str(n), float(us))
                                     for n, us in e["timings_us"]))
            except (KeyError, TypeError, ValueError):
                continue
            if tuned.impl not in known or key in _AUTOTUNE_CACHE:
                continue
            _AUTOTUNE_CACHE[key] = tuned
            loaded += 1
    return loaded

"""K4: K1 with anytime early exit (tile pruning).

Replaces the TPU kernel ``repro/kernels/fastscan_kernel.py::
fastscan_stream_topk_grouped`` with ``early_exit=True`` (Pallas body
``_stream_topk_prune_kernel``, merge ``_merge_smallest``); the CUDA source
is ``csrc/fastscan_stream_topk_prune.cu``. Each query's (probe, tile) steps
run in flat order with a running top-kc of dequantized distances; a step
whose group bound is not below the running kc-th best is skipped: it reads
nothing, emits sentinels and counts in ``skipped``. The reference's result
depends on that order, so the kernel runs one CTA per query; it is bound by
memory for the tiles it scans, and in practice by the latency of its serial
steps: each scanned step selects the tile's top-kc with a histogram (radix)
select, sorts and merges it by rank, and prefetches the next step's
operands with TMA bulk copies.

Beside the kernel: ``fastscan_stream_topk_prune_plain``, the same function
in plain PyTorch (the CPU path and the on-card reference), and
``launches``, the count of kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import fastscan_kernel as fk

launches = 0


# the kernel's CTA shape and plan (csrc/fastscan_stream_topk_prune.cu)
_THREADS, _MAX_DIGIT_BITS, _SCRATCH = 1024, 13, 48


def _a16(x: int) -> int:
    return -(-x // 16) * 16


def _layout_bytes(tile_n: int, kc: int, m: int, stages: int,
                  digit_bits: int) -> int:
    stage = _a16(m * 16)
    if stages == 2:
        stage += _a16(tile_n * (m // 2)) + _a16(tile_n // 8 + 2)
    return (_SCRATCH + -(-tile_n // _THREADS) * (_THREADS // 32) * 4
            + _a16(tile_n * 4)
            + _a16((1 << digit_bits) * 4) + _a16(kc * 8) + _a16(kc * 4)
            + _a16(kc * 8) + stages * stage)


def smem_bytes(tile_n: int, kc: int, m: int) -> int:
    """Shared memory one CTA needs (mirrors the plan in the .cu, which
    exports it as ``repro_fastscan_stream_topk_prune_smem``): the tile's
    sums, the radix select's histogram, the survivors' keys and distances,
    two running top-kc buffers, and two prefetch stages of (LUT, code rows,
    filter bytes) -- or, where those do not fit, one LUT stage, or none, at
    the widest histogram that fits."""
    dmax = min((m * 255).bit_length(), _MAX_DIGIT_BITS)
    need = _layout_bytes(tile_n, kc, m, 2, dmax)
    for stages in (1, 0):
        for d in range(dmax, 0, -1):
            if need <= _build.SMEM_LIMIT:
                return need
            need = _layout_bytes(tile_n, kc, m, stages, d)
    return need


def _check(table_q8, list_codes, probe_ids, sizes, bounds, scales, biases,
           filter_bits, kc, tile_n, gpq):
    fk._check(table_q8, list_codes, probe_ids, sizes, filter_bits, kc, tile_n)
    g, m, _ = table_q8.shape
    _build.check_args({"bounds": (bounds, torch.float32, 1),
                       "scales": (scales, torch.float32, 1),
                       "biases": (biases, torch.float32, 1)}, table_q8.device)
    if not bounds.shape == scales.shape == biases.shape == (g,):
        raise ValueError(f"bounds/scales/biases {tuple(bounds.shape)} "
                         f"{tuple(scales.shape)} {tuple(biases.shape)}: "
                         f"want ({g},)")
    if gpq < 1 or g % gpq:
        raise ValueError(f"groups_per_query={gpq} must be >= 1 and divide "
                         f"G={g}")
    if smem_bytes(tile_n, kc, m) > _build.SMEM_LIMIT:
        raise ValueError(f"tile_n={tile_n}, kc={kc} need "
                         f"{smem_bytes(tile_n, kc, m)} B of shared memory")


def fastscan_stream_topk_prune_plain(table_q8, list_codes, probe_ids, sizes,
                                     bounds, scales, biases, *, kc: int,
                                     tile_n: int, groups_per_query: int,
                                     filter_bits=None
                                     ) -> tuple[torch.Tensor, ...]:
    """The kernel's function in plain PyTorch, same arguments and result.

    A scanned step emits what K1 emits for that tile, so K1's plain version
    gives every tile's candidates up front; the loop then walks the flat
    (probe, tile) steps of all queries at once, with the running top-kc as
    a (Q, kc) tensor, and decides which steps are scanned.
    """
    vals, slots = fk.fastscan_stream_topk_plain(
        table_q8, list_codes, probe_ids, sizes, kc=kc, tile_n=tile_n,
        filter_bits=filter_bits)
    g, n_tiles = vals.shape[:2]
    gpq = groups_per_query
    dev = table_q8.device
    first = torch.arange(g // gpq, device=dev) * gpq   # each query's group 0
    run = torch.full((g // gpq, kc), torch.inf, device=dev)
    scanned = torch.zeros((g, n_tiles), dtype=torch.bool, device=dev)
    for s in range(gpq * n_tiles):
        p, t = divmod(s, n_tiles)
        gi = first + p
        scan = (probe_ids[gi] >= 0) & (bounds[gi] < run[:, kc - 1])
        scanned[gi, t] = scan
        # the host's dequantization, two rounded ops; a step not scanned
        # adds only +inf, which leaves the running top-kc as it is
        d = scales[gi, None] * vals[gi, t].float() + biases[gi, None]
        d = torch.where(scan[:, None] & (slots[gi, t] >= 0), d, torch.inf)
        run = torch.sort(torch.cat([run, d], dim=1), dim=1).values[:, :kc]
    vals = torch.where(scanned[..., None], vals, fk.ACC_SENTINEL)
    slots = torch.where(scanned[..., None], slots, -1)
    skipped = ((probe_ids >= 0)[:, None] & ~scanned).to(torch.int32)
    return vals.contiguous(), slots.contiguous(), skipped


def fastscan_stream_topk_prune(table_q8: torch.Tensor,
                               list_codes: torch.Tensor,
                               probe_ids: torch.Tensor, sizes: torch.Tensor,
                               bounds: torch.Tensor, scales: torch.Tensor,
                               biases: torch.Tensor, *, kc: int, tile_n: int,
                               groups_per_query: int,
                               filter_bits: torch.Tensor | None = None
                               ) -> tuple[torch.Tensor, ...]:
    """Gather-free grouped ADC with fused top-kc and early exit.

    K1's operands plus, per group, (G,) f32: ``bounds`` (a lower bound on
    any of its dequantized distances), ``scales`` and ``biases`` (the
    dequantization ``scale * val + bias``); ``groups_per_query`` groups per
    query, query-major. Returns (vals (G, n_tiles, kc) i32, slots
    (G, n_tiles, kc) i32, skipped (G, n_tiles) i32 -- 1 where a valid
    probe's tile was pruned and emitted sentinels).

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise. Inputs must be contiguous, of the stated dtypes, on one device.
    """
    global launches
    _check(table_q8, list_codes, probe_ids, sizes, bounds, scales, biases,
           filter_bits, kc, tile_n, groups_per_query)
    dev = table_q8.device
    if dev.type == "cpu":
        return fastscan_stream_topk_prune_plain(
            table_q8, list_codes, probe_ids, sizes, bounds, scales, biases,
            kc=kc, tile_n=tile_n, groups_per_query=groups_per_query,
            filter_bits=filter_bits)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    g, m, _ = table_q8.shape
    cap = list_codes.shape[1]
    n_tiles = cap // tile_n
    vals = torch.empty((g, n_tiles, kc), dtype=torch.int32, device=dev)
    slots = torch.empty_like(vals)
    skipped = torch.empty((g, n_tiles), dtype=torch.int32, device=dev)
    if g * n_tiles == 0:
        return vals, slots, skipped
    _build.check_smem("repro_fastscan_stream_topk_prune_smem", tile_n, kc, m,
                      what=f"tile_n={tile_n}, kc={kc}, M={m}")
    lib = _build.load_library()
    w = 0 if filter_bits is None else filter_bits.shape[1]
    with torch.cuda.device(dev):
        err = lib.repro_fastscan_stream_topk_prune(
            table_q8.data_ptr(), list_codes.data_ptr(), probe_ids.data_ptr(),
            sizes.data_ptr(),
            None if filter_bits is None else filter_bits.data_ptr(),
            bounds.data_ptr(), scales.data_ptr(), biases.data_ptr(), g, m,
            cap, w, tile_n, kc, groups_per_query, vals.data_ptr(),
            slots.data_ptr(), skipped.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "fastscan_stream_topk_prune")
    launches += 1
    return vals, slots, skipped

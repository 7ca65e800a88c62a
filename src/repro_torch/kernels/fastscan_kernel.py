"""K1: gather-free grouped 4-bit ADC with fused per-tile top-kc.

Replaces the TPU kernel ``repro/kernels/fastscan_kernel.py::
fastscan_stream_topk_grouped`` with ``early_exit=False`` (Pallas body
``_stream_topk_kernel``, selection ``_tile_topk``); the CUDA source is
``csrc/fastscan_stream_topk.cu``. It is bound by memory on the H100: each
probed list is read once, M/2 bytes a row, for M table look-ups and adds.
One CTA per (group, tile) looks its rows up four at a time with byte
permutes, finds the tile's kc-th smallest sum with a shared-memory
histogram (radix) select, compacts the rows under it in slot order and
ranks them; no tile is sorted. Its measured time stands in PERF.md beside
its bound.

Beside the kernel: ``fastscan_stream_topk_plain``, the same function in
plain PyTorch (the CPU path and the on-card reference), and ``launches``,
the count of kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.core.lists import unpack_filter_mask
from repro_torch.kernels import _build
from repro_torch.kernels import ref as ref_mod

# Larger than any reachable ADC sum (<= 128 sub-spaces * 255); marks padded,
# filtered-out and invalid-probe slots inside the selection.
ACC_SENTINEL = 2**31 - 1
# default cap tile (the reference's TILE_N)
TILE_N = 1024
SMEM_LIMIT = _build.SMEM_LIMIT

launches = 0


# the kernel's shared-memory plan (csrc/fastscan_stream_topk.cu)
_MAX_DIGIT_BITS, _SCRATCH = 12, 48


def _a16(x: int) -> int:
    return -(-x // 16) * 16


def _layout_bytes(tile_n: int, kc: int, m: int, digit_bits: int,
                  lut_smem: bool) -> int:
    return (_SCRATCH + _a16(tile_n * 4) + _a16((1 << digit_bits) * 4)
            + 2 * _a16(kc * 4) + (_a16(m * 16) if lut_smem else 0))


def smem_bytes(tile_n: int, kc: int, m: int) -> int:
    """Shared memory one CTA needs (mirrors the plan in the .cu, which
    exports it as ``repro_fastscan_stream_topk_smem``): the tile's sums, the
    radix select's histogram, the candidates' values and slots, and the
    group's (M, 16) u8 LUT -- or, where that does not fit, a narrower
    histogram, then the LUT read in place."""
    dmax = min((m * 255).bit_length(), _MAX_DIGIT_BITS)
    need = _layout_bytes(tile_n, kc, m, dmax, True)
    for lut_smem in (True, False):
        for d in range(dmax, 0, -1):
            if need <= SMEM_LIMIT:
                return need
            need = _layout_bytes(tile_n, kc, m, d, lut_smem)
    return need


def _check(table_q8, list_codes, probe_ids, sizes, filter_bits, kc, tile_n):
    args = {"table_q8": (table_q8, torch.uint8, 3),
            "list_codes": (list_codes, torch.uint8, 3),
            "probe_ids": (probe_ids, torch.int32, 1),
            "sizes": (sizes, torch.int32, 1)}
    if filter_bits is not None:
        args["filter_bits"] = (filter_bits, torch.uint8, 2)
    _build.check_args(args, table_q8.device)
    g, m, k = table_q8.shape
    nlist, cap, mh = list_codes.shape
    if k != 16 or 2 * mh != m:
        raise ValueError(f"table_q8 {tuple(table_q8.shape)} does not match "
                         f"list_codes {tuple(list_codes.shape)} (K=16, M=2*M/2)")
    if probe_ids.shape != (g,) or sizes.shape != (nlist,):
        raise ValueError(f"probe_ids {tuple(probe_ids.shape)} / sizes "
                         f"{tuple(sizes.shape)}: want ({g},) / ({nlist},)")
    if filter_bits is not None and (filter_bits.shape[0] != nlist
                                    or filter_bits.shape[1] * 8 < cap):
        raise ValueError(f"filter_bits {tuple(filter_bits.shape)}: want "
                         f"({nlist}, >= ceil({cap}/8))")
    if tile_n < 1 or cap % tile_n:
        raise ValueError(f"tile_n={tile_n} must divide cap={cap}")
    if not 1 <= kc <= tile_n:
        raise ValueError(f"kc={kc} must be in [1, tile_n={tile_n}]")
    if smem_bytes(tile_n, kc, m) > SMEM_LIMIT:
        raise ValueError(f"tile_n={tile_n}, kc={kc} need "
                         f"{smem_bytes(tile_n, kc, m)} B of shared memory, "
                         f"more than the {SMEM_LIMIT} B a block can get")


def fastscan_stream_topk_plain(table_q8, list_codes, probe_ids, sizes, *,
                               kc: int, tile_n: int, filter_bits=None
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch, same arguments and result.

    Follows ``_tile_topk``'s order: a stable ascending sort of each tile
    puts equal values in slot order, which is what repeated first-occurrence
    argmin extraction yields.
    """
    g = table_q8.shape[0]
    cap = list_codes.shape[1]
    n_tiles = cap // tile_n
    dev = table_q8.device
    lid = torch.clamp_min(probe_ids, 0).long()
    acc = ref_mod.fastscan_grouped_ref(table_q8, list_codes[lid])  # (G, cap)
    slot = torch.arange(cap, device=dev)
    live = (slot < sizes[lid][:, None]) & (probe_ids >= 0)[:, None]
    if filter_bits is not None:
        live &= unpack_filter_mask(filter_bits[lid], cap)
    acc = torch.where(live, acc, ACC_SENTINEL)
    vals, order = torch.sort(acc.reshape(g, n_tiles, tile_n), dim=-1,
                             stable=True)
    vals = vals[..., :kc].contiguous()
    base = (torch.arange(n_tiles, device=dev) * tile_n)[:, None]
    slots = (order[..., :kc] + base).to(torch.int32)
    return vals, torch.where(vals == ACC_SENTINEL, -1, slots).contiguous()


def fastscan_stream_topk_grouped(table_q8: torch.Tensor,
                                 list_codes: torch.Tensor,
                                 probe_ids: torch.Tensor, sizes: torch.Tensor,
                                 *, kc: int, tile_n: int = TILE_N,
                                 filter_bits: torch.Tensor | None = None
                                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Gather-free grouped ADC with fused candidate reduction + filtering.

    table_q8 (G, M, 16) u8; list_codes (nlist, cap, M//2) u8, read in place;
    probe_ids (G,) i32 (-1 = no probe); sizes (nlist,) i32; filter_bits
    optional (nlist, W) u8 bitmap, read in place by list id. Returns
    (vals (G, n_tiles, kc) i32, slots (G, n_tiles, kc) i32): per (group,
    cap tile) the kc smallest ADC sums ascending and their slot in the list,
    lowest slot first among equal sums, -1 = absent.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise. Inputs must be contiguous, of the stated dtypes, on one device.
    """
    global launches
    _check(table_q8, list_codes, probe_ids, sizes, filter_bits, kc, tile_n)
    dev = table_q8.device
    if dev.type == "cpu":
        return fastscan_stream_topk_plain(table_q8, list_codes, probe_ids,
                                          sizes, kc=kc, tile_n=tile_n,
                                          filter_bits=filter_bits)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    g, m, _ = table_q8.shape
    nlist, cap, _ = list_codes.shape
    n_tiles = cap // tile_n
    if g * n_tiles >= 2**31:
        raise ValueError(f"grid of {g}x{n_tiles} blocks is too large")
    vals = torch.empty((g, n_tiles, kc), dtype=torch.int32, device=dev)
    slots = torch.empty_like(vals)
    if g * n_tiles == 0:
        return vals, slots
    _build.check_smem("repro_fastscan_stream_topk_smem", tile_n, kc, m,
                      what=f"tile_n={tile_n}, kc={kc}, M={m}")
    lib = _build.load_library()
    w = 0 if filter_bits is None else filter_bits.shape[1]
    with torch.cuda.device(dev):
        err = lib.repro_fastscan_stream_topk(
            table_q8.data_ptr(), list_codes.data_ptr(), probe_ids.data_ptr(),
            sizes.data_ptr(),
            None if filter_bits is None else filter_bits.data_ptr(),
            g, m, cap, w, tile_n, kc, vals.data_ptr(), slots.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "fastscan_stream_topk")
    launches += 1
    return vals, slots

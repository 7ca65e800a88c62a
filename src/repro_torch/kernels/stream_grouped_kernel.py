"""K3: gather-free grouped 4-bit ADC over the list store in place.

Replaces the TPU kernel ``repro/kernels/fastscan_kernel.py::
fastscan_stream_grouped`` (Pallas body ``_stream_grouped_kernel``); the
CUDA source is ``csrc/fastscan_stream_grouped.cu``. It is K1's scan with no
occupancy mask and no selection: the full (G, cap) i32 sums, zeros for a
-1 probe. It is K5's design with one indirection: persistent CTAs walk
(group, row chunk) units, a ``cp.async`` ring stages each unit's LUT beside
its rows, copied from the probed list in place, and four rows a byte
permute pair are summed from the stage. It serves
``scan_probes(impl='stream')`` (hand composition, ``SearchEngine.scan``)
and the scan autotuner's 'stream' candidate. Bound by memory on the H100
(each probed list read once, each sum written once); the kernel is held
back by the look-up's integer-ALU instructions, as K5 is.

Beside the kernel: ``fastscan_stream_grouped_plain``, the same function in
plain PyTorch (the CPU path and the on-card reference), ``smem_bytes``, the
shared memory a CTA takes, and ``launches``, the count of kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as ref_mod

launches = 0
_UNIT_ROWS = 4096                         # rows of a full unit
_STAGES = 3                               # the ring's stages
_FOUR_ROW = (1, 2, 3, 4, 6, 8, 12, 16)    # M/2 of the four-row look-up


def _align16(x: int) -> int:
    return (x + 15) & ~15


def smem_bytes(m: int) -> int:
    """Shared memory one K3 CTA takes at M sub-spaces (mirrors
    ``smem_bytes`` and ``repro_fastscan_stream_grouped_smem`` in the .cu):
    on the four-row path a ring of 3 stages, each the group's LUT and a
    chunk of 4,096 code rows; at any other M the LUT alone."""
    if m // 2 in _FOUR_ROW:
        return _STAGES * (_align16(16 * m) + _align16(_UNIT_ROWS * (m // 2)))
    return 16 * m


def _check(table_q8, list_codes, probe_ids, tile_n):
    _build.check_args({"table_q8": (table_q8, torch.uint8, 3),
                       "list_codes": (list_codes, torch.uint8, 3),
                       "probe_ids": (probe_ids, torch.int32, 1)},
                      table_q8.device)
    g, m, k = table_q8.shape
    nlist, cap, mh = list_codes.shape
    if k != 16 or 2 * mh != m:
        raise ValueError(f"table_q8 {tuple(table_q8.shape)} does not match "
                         f"list_codes {tuple(list_codes.shape)} (K=16, M=2*M/2)")
    if probe_ids.shape != (g,):
        raise ValueError(f"probe_ids {tuple(probe_ids.shape)}: want ({g},)")
    if tile_n < 1 or cap % tile_n:
        raise ValueError(f"tile_n={tile_n} must divide cap={cap}")
    if smem_bytes(m) > _build.SMEM_LIMIT:
        raise ValueError(f"M={m} needs {smem_bytes(m)} B of shared memory")


def fastscan_stream_grouped_plain(table_q8, list_codes, probe_ids, *,
                                  tile_n: int) -> torch.Tensor:
    """The kernel's function in plain PyTorch, same arguments and result."""
    lid = torch.clamp_min(probe_ids, 0).long()
    acc = ref_mod.fastscan_grouped_ref(table_q8, list_codes[lid])
    return torch.where((probe_ids >= 0)[:, None], acc, 0)


def fastscan_stream_grouped(table_q8: torch.Tensor, list_codes: torch.Tensor,
                            probe_ids: torch.Tensor, *, tile_n: int
                            ) -> torch.Tensor:
    """(G, M, 16) u8 LUTs x (nlist, cap, M//2) u8 codes read in place +
    (G,) i32 probe ids -> (G, cap) i32 sums of every slot (padding
    included), zeros for a -1 probe. ``tile_n`` must divide cap.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise. Inputs must be contiguous, of the stated dtypes, on one device.
    """
    global launches
    _check(table_q8, list_codes, probe_ids, tile_n)
    dev = table_q8.device
    if dev.type == "cpu":
        return fastscan_stream_grouped_plain(table_q8, list_codes, probe_ids,
                                             tile_n=tile_n)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    g, m, _ = table_q8.shape
    cap = list_codes.shape[1]
    if g * (cap // tile_n) >= 2**31:
        raise ValueError(f"grid of {g}x{cap // tile_n} blocks is too large")
    out = torch.empty((g, cap), dtype=torch.int32, device=dev)
    if out.numel() == 0:
        return out
    _build.check_smem("repro_fastscan_stream_grouped_smem", m)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        err = lib.repro_fastscan_stream_grouped(
            table_q8.data_ptr(), list_codes.data_ptr(), probe_ids.data_ptr(),
            g, m, cap, tile_n, out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "fastscan_stream_grouped")
    launches += 1
    return out

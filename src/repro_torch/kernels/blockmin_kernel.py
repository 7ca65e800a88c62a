"""K7c: flat 4-bit ADC fused with a per-block min and first-occurrence
argmin.

Replaces the TPU kernel ``repro/kernels/fastscan_kernel.py::
fastscan_blockmin`` (Pallas body ``_blockmin_kernel``); the CUDA source is
``csrc/fastscan_blockmin.cu``. K7b's tensor-core sums (the one-hot of 16
code rows against up to 8 query tiles' LUT words) are folded into the
minimum where K7b would store them: persistent CTAs each own a run of whole
blocks and walk it in row chunks through a ``cp.async`` ring, keeping a
running (sum, row) per query, merged on ``(sum << 32 | row)`` keys, whose
minimum per (query, block) is the smallest sum and, among equal sums, the
lowest row. The (Q, N) sums never reach device memory. It serves
``ops.fastscan_blockmin``. Bound by memory on the H100: the codes read once
a query block, two i32 written per (query, block).

Beside the kernel: ``fastscan_blockmin_plain``, the same function in plain
PyTorch (the CPU path and the on-card reference), and ``launches``, the
count of kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as ref_mod
from repro_torch.kernels import select_flat_kernel as sfk

launches = 0


def _check(table_q8, codes, tile_n: int) -> None:
    sfk.check_flat(table_q8, codes)
    n = codes.shape[0]
    if tile_n < 1 or n % tile_n:
        raise ValueError(f"tile_n={tile_n} must divide N={n} (pad the codes)")


def fastscan_blockmin_plain(table_q8, codes, *, tile_n: int
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch, same arguments and result."""
    return ref_mod.fastscan_block_min_ref(table_q8, codes, tile_n)


def fastscan_blockmin(table_q8: torch.Tensor, codes: torch.Tensor, *,
                      tile_n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(Q, M, 16) u8 x (N, M//2) u8 -> (mins (Q, N/tile_n) i32, ids
    (Q, N/tile_n) i32): per query and block of ``tile_n`` rows (any size
    dividing N) the smallest ADC sum and the global id of its first row.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise. Inputs must be contiguous, of the stated dtypes, on one device.
    """
    global launches
    _check(table_q8, codes, tile_n)
    dev = table_q8.device
    if dev.type == "cpu":
        return fastscan_blockmin_plain(table_q8, codes, tile_n=tile_n)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    q, m, _ = table_q8.shape
    n = codes.shape[0]
    _build.check_smem("repro_fastscan_blockmin_smem", m)
    nb = n // tile_n
    mins = torch.empty((q, nb), dtype=torch.int32, device=dev)
    ids = torch.empty((q, nb), dtype=torch.int32, device=dev)
    if mins.numel() == 0:
        return mins, ids
    lib = _build.load_library()
    with torch.cuda.device(dev):
        err = lib.repro_fastscan_blockmin(
            table_q8.data_ptr(), codes.data_ptr(), q, m, n, tile_n,
            mins.data_ptr(), ids.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "fastscan_blockmin")
    launches += 1
    return mins, ids

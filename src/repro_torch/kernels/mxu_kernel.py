"""K6: grouped 4-bit ADC over a gathered copy as a one-hot matrix product
on the tensor cores (the 'mxu' formulation).

Replaces the TPU kernel ``repro/kernels/fastscan_kernel.py::
fastscan_onehot_mxu_grouped`` (Pallas body ``_onehot_mxu_grouped_kernel``);
the CUDA source is ``csrc/fastscan_onehot_mma_grouped.cu``. One u8 x u8 ->
s32 MMA per sub-space: 16 one-hot code rows against the group's LUT row as
B's first column, exact in s32. It is the ``scan_impl='mxu'`` path and a
candidate of the scan autotuner. Bound by memory on the H100, as K5; 15/16
of each MMA multiplies zeros, which this first version accepts.

Beside the kernel: the plain version is K5's ``fastscan_grouped_plain``
(the two compute one function), and ``launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import select_kernel as sk

launches = 0
# warps of a CTA; each has a 256 B A-tile and a 16x16 s32 C-tile
_WARPS = 8


def smem_bytes(m: int) -> int:
    """Shared memory one CTA needs (mirrors the launcher in the .cu): the
    M B-tiles plus each warp's A- and C-tile."""
    return m * 256 + _WARPS * (256 + 1024)


def fastscan_onehot_mxu_grouped(table_q8: torch.Tensor, codes: torch.Tensor,
                                *, tile_n: int) -> torch.Tensor:
    """Grouped ADC on the tensor cores: (G, M, 16) u8 x (G, N, M//2) u8 ->
    (G, N) i32, N a multiple of ``tile_n``; equal to K5 bit for bit.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise. Inputs must be contiguous, of the stated dtypes, on one device.
    """
    global launches
    sk.check_grouped(table_q8, codes, tile_n, smem_bytes(table_q8.shape[1]))
    if table_q8.device.type == "cpu":
        return sk.fastscan_grouped_plain(table_q8, codes, tile_n=tile_n)
    out = sk.launch_grouped("repro_fastscan_onehot_mma_grouped", table_q8,
                            codes, tile_n)
    launches += int(out.numel() > 0)
    return out

"""K6: grouped 4-bit ADC over a gathered copy as a one-hot matrix product
on the tensor cores (the 'mxu' formulation).

Replaces the TPU kernel ``repro/kernels/fastscan_kernel.py::
fastscan_onehot_mxu_grouped`` (Pallas body ``_onehot_mxu_grouped_kernel``);
the CUDA source is ``csrc/fastscan_onehot_mma_grouped.cu``. u8 x u8 ->
s32 ``mma.sync.m16n8k32``, one k-step a packed code byte (two sub-spaces):
A is the one-hot of 16 code rows, built in registers, B the group's LUT
in all 8 columns, of which column 0 is read; exact in s32. Persistent CTAs walk
(group, row chunk) units with a ``cp.async`` ring that stages each unit's
LUT beside its codes, and the sums leave through shared memory as 16-byte
stores. It is the ``scan_impl='mxu'`` path and a candidate of the scan
autotuner. Bound by memory on the H100, as K5.

Beside the kernel: the plain version is K5's ``fastscan_grouped_plain``
(the two compute one function), and ``launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import select_kernel as sk

launches = 0
_WARPS = 8      # warps of a CTA; a unit is 16 * _WARPS * rb code rows


def _align16(x: int) -> int:
    return (x + 15) & ~15


def _layout(m: int, rb: int, stages: int) -> int:
    rows = 16 * _WARPS * rb
    return 2 * rows * 4 + stages * (_align16(16 * m) +
                                    _align16(rows * (m // 2)))


def smem_bytes(m: int) -> int:
    """Shared memory one CTA takes at M sub-spaces (mirrors ``plan`` and
    ``repro_fastscan_onehot_mma_grouped_smem`` in the .cu): two buffers of
    a chunk's sums, then a ring of stages, each a LUT and a code chunk; the
    largest row-block count rb in (16, 8, 4, 2, 1), then the most stages
    in (4, 3), that fits (a launch over few groups takes a smaller rb, and
    less). Above ``SMEM_LIMIT`` when none does."""
    for rb in (16, 8, 4, 2, 1):
        for stages in (4, 3):
            if _layout(m, rb, stages) <= _build.SMEM_LIMIT:
                return _layout(m, rb, stages)
    return _layout(m, 1, 3)


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
    _build.check_smem("repro_fastscan_onehot_mma_grouped_smem",
                      table_q8.shape[1])
    out = sk.launch_grouped("repro_fastscan_onehot_mma_grouped", table_q8,
                            codes, tile_n)
    launches += int(out.numel() > 0)
    return out

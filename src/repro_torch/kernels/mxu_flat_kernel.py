"""K7b: flat 4-bit ADC as a one-hot matrix product on the tensor cores (the
'mxu' formulation, the flat index's default).

Replaces the TPU kernel ``repro/kernels/fastscan_kernel.py::
fastscan_onehot_mxu`` (Pallas body ``_onehot_mxu_kernel``); the CUDA
source is ``csrc/fastscan_onehot_mma_flat.cu``. u8 x u8 -> s32
``mma.sync.m16n8k32``: A is the one-hot of 16 code rows, built in
registers once per k-step (one packed code byte) and fed to the MMAs of up
to 8 query tiles, B is 8 queries' LUT words from shared memory; exact in
s32. Persistent CTAs walk row chunks with a ``cp.async`` ring, and the
sums leave through a shared-memory (query, row) tile as 16-byte streaming
stores. It is the flat index's ``impl='mxu'`` path. Bound by memory on the
H100, as K7a: the (Q, N) i32 output is ~98% of the bytes.

Beside the kernel: the plain version is K7a's ``fastscan_distances_plain``
(the two compute one function), and ``launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import select_flat_kernel as sfk

launches = 0


def fastscan_onehot_mxu(table_q8: torch.Tensor, codes: torch.Tensor
                        ) -> torch.Tensor:
    """Flat ADC on the tensor cores: (Q, M, 16) u8 x (N, M//2) u8 ->
    (Q, N) i32, any Q and N; equal to K7a bit for bit.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise. Inputs must be contiguous, of the stated dtypes, on one device.
    """
    global launches
    sfk.check_flat(table_q8, codes)
    if table_q8.device.type == "cpu":
        return sfk.fastscan_distances_plain(table_q8, codes)
    out = sfk.launch_flat("repro_fastscan_onehot_mma_flat", table_q8, codes)
    launches += int(out.numel() > 0)
    return out

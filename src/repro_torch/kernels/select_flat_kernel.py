"""K7a: flat 4-bit ADC over one shared code database, the register-shuffle
('select') formulation.

Replaces the TPU kernel ``repro/kernels/fastscan_kernel.py::
fastscan_select_tree`` (Pallas body ``_select_tree_kernel``); the CUDA
source is ``csrc/fastscan_select_flat.cu``. One byte-permute pair looks up
four rows of a sub-space at once (the paper's one shuffle for many codes):
each thread builds the selectors and bit-3 masks of its four rows once per
tile and walks a CTA's 16 queries over them, summing in 16-bit lanes. It is
the flat index's ``impl='select'`` path (``ops.fastscan_distances``,
``core.fastscan.compute_distances`` / ``search``). Bound by memory on the
H100: the (Q, N) i32 output is ~98% of the bytes.

Beside the kernel: ``fastscan_distances_plain``, the same function in
plain PyTorch (the CPU path and the on-card reference of both K7a and K7b,
which compute one function), and ``launches``, the count of kernel
launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as ref_mod

launches = 0


def check_flat(table_q8, codes) -> None:
    """Input checks shared by K7a-K7c: (Q, M, 16) u8 tables and (N, M//2)
    u8 codes, contiguous, on one device."""
    _build.check_args({"table_q8": (table_q8, torch.uint8, 3),
                       "codes": (codes, torch.uint8, 2)}, table_q8.device)
    q, m, k = table_q8.shape
    n, mh = codes.shape
    if k != 16 or mh < 1 or 2 * mh != m:
        raise ValueError(f"table_q8 {tuple(table_q8.shape)} does not match "
                         f"codes {tuple(codes.shape)} (K=16, M=2*M/2 >= 2)")
    if q >= 2**31 or n >= 2**31:
        raise ValueError(f"Q={q} and N={n} must stay below 2**31")


def fastscan_distances_plain(table_q8, codes) -> torch.Tensor:
    """K7a's and K7b's function in plain PyTorch: (Q, N) i32 sums."""
    return ref_mod.fastscan_distances_ref(table_q8, codes)


def launch_flat(fn_name: str, table_q8: torch.Tensor, codes: torch.Tensor
                ) -> torch.Tensor:
    """Launch K7a or K7b on CUDA tensors the caller has checked; an empty
    output launches nothing."""
    dev = table_q8.device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    q, m, _ = table_q8.shape
    n = codes.shape[0]
    _build.check_smem(fn_name + "_smem", m)
    out = torch.empty((q, n), dtype=torch.int32, device=dev)
    if out.numel() == 0:
        return out
    lib = _build.load_library()
    with torch.cuda.device(dev):
        err = getattr(lib, fn_name)(
            table_q8.data_ptr(), codes.data_ptr(), q, m, n, out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, fn_name)
    return out


def fastscan_select_tree(table_q8: torch.Tensor, codes: torch.Tensor
                         ) -> torch.Tensor:
    """Flat ADC: (Q, M, 16) u8 x (N, M//2) u8 -> (Q, N) i32, any Q and N.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise. Inputs must be contiguous, of the stated dtypes, on one device.
    """
    global launches
    check_flat(table_q8, codes)
    if table_q8.device.type == "cpu":
        return fastscan_distances_plain(table_q8, codes)
    out = launch_flat("repro_fastscan_select_flat", table_q8, codes)
    launches += int(out.numel() > 0)
    return out

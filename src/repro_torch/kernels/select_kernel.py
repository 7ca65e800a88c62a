"""K5: grouped 4-bit ADC over a gathered copy, the register-shuffle
('select') formulation.

Replaces the TPU kernel ``repro/kernels/fastscan_kernel.py::
fastscan_select_tree_grouped`` (Pallas body
``_select_tree_grouped_kernel``); the CUDA source is
``csrc/fastscan_select_grouped.cu``. One byte-permute pair looks up four
rows of a sub-space at once, the Hopper analogue of the paper's
``vqtbl1q_u8`` shuffles (K7a's look-up, the group's LUT read from shared
memory); persistent CTAs walk (group, row chunk) units with a ``cp.async``
ring that stages each unit's LUT beside its codes. It is the
``scan_impl='select'`` path and a candidate of the scan autotuner. Bound by
memory on the H100: the gathered copy is read once, the sums written once.

Beside the kernel: ``fastscan_grouped_plain``, the same function in plain
PyTorch (the CPU path and the on-card reference of both K5 and K6, which
compute one function), ``smem_bytes``, the shared memory a CTA takes, and
``launches``, the count of kernel launches.
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
    """Shared memory one K5 CTA takes at M sub-spaces (mirrors
    ``smem_bytes`` and ``repro_fastscan_select_grouped_smem`` in the .cu):
    on the four-row path a ring of 3 stages, each the group's LUT and a
    chunk of 4,096 code rows; at any other M the LUT alone."""
    if m // 2 in _FOUR_ROW:
        return _STAGES * (_align16(16 * m) + _align16(_UNIT_ROWS * (m // 2)))
    return 16 * m


def check_grouped(table_q8, codes, tile_n, smem: int) -> None:
    """Input checks shared by K5 and K6: (G, M, 16) u8 x (G, N, M//2) u8,
    ``tile_n`` dividing N, ``smem`` bytes of shared memory a block."""
    _build.check_args({"table_q8": (table_q8, torch.uint8, 3),
                       "codes": (codes, torch.uint8, 3)}, table_q8.device)
    g, m, k = table_q8.shape
    gc, n, mh = codes.shape
    if k != 16 or 2 * mh != m or gc != g:
        raise ValueError(f"table_q8 {tuple(table_q8.shape)} does not match "
                         f"codes {tuple(codes.shape)} (K=16, M=2*M/2, same G)")
    if tile_n < 1 or n % tile_n:
        raise ValueError(f"tile_n={tile_n} must divide N={n} (pad the copy)")
    if g * (n // tile_n) >= 2**31:
        raise ValueError(f"grid of {g}x{n // tile_n} blocks is too large")
    if smem > _build.SMEM_LIMIT:
        raise ValueError(f"M={m} needs {smem} B of shared memory, more than "
                         f"the {_build.SMEM_LIMIT} B a block can get")


def fastscan_grouped_plain(table_q8, codes, *, tile_n: int) -> torch.Tensor:
    """K5's and K6's function in plain PyTorch: (G, N) i32 sums."""
    return ref_mod.fastscan_grouped_ref(table_q8, codes)


def launch_grouped(fn_name: str, table_q8: torch.Tensor, codes: torch.Tensor,
                   tile_n: int) -> torch.Tensor:
    """Launch one of the gathered grouped kernels (K5 or K6) on CUDA
    tensors the caller has checked; an empty output launches nothing."""
    dev = table_q8.device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    g, m, _ = table_q8.shape
    n = codes.shape[1]
    out = torch.empty((g, n), dtype=torch.int32, device=dev)
    if out.numel() == 0:
        return out
    lib = _build.load_library()
    with torch.cuda.device(dev):
        err = getattr(lib, fn_name)(
            table_q8.data_ptr(), codes.data_ptr(), g, m, n, tile_n,
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, fn_name)
    return out


def fastscan_select_tree_grouped(table_q8: torch.Tensor, codes: torch.Tensor,
                                 *, tile_n: int) -> torch.Tensor:
    """Grouped ADC: (G, M, 16) u8 x (G, N, M//2) u8 -> (G, N) i32, N a
    multiple of ``tile_n`` (the caller pads the gathered copy).

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise. Inputs must be contiguous, of the stated dtypes, on one device.
    """
    global launches
    check_grouped(table_q8, codes, tile_n, smem_bytes(table_q8.shape[1]))
    if table_q8.device.type == "cpu":
        return fastscan_grouped_plain(table_q8, codes, tile_n=tile_n)
    _build.check_smem("repro_fastscan_select_grouped_smem", table_q8.shape[1])
    out = launch_grouped("repro_fastscan_select_grouped", table_q8, codes,
                         tile_n)
    launches += int(out.numel() > 0)
    return out

"""K2: gather-free exact re-rank with a running top-k.

Replaces the TPU kernel ``repro/kernels/rerank_kernel.py::
rerank_stream_topk`` (Pallas body ``_rerank_kernel``, merge ``_merge_topk``,
distance ``norms_gemm_dists``); the CUDA source is
``csrc/rerank_stream_topk.cu``. It is bound by memory on the H100: each
candidate row (D*4 bytes, gathered by id from the in-place base) is read
once for 2*D flops. This first version is simple on purpose -- one CTA per
query, one warp per candidate row, the running top-k merged by a
shared-memory bitonic sort -- and its measured time stands in PERF.md
beside its bound.

The kernel and torch sum the dot products in different orders, so the two
agree within an f32 tolerance, not bit for bit (chip_smoke.py states it).

Beside the kernel: ``rerank_stream_topk_plain``, the same function in
plain PyTorch (the CPU path and the on-card reference), and ``launches``,
the count of kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

# default candidate-chunk size (the reference's TILE_R)
TILE_R = 64
SMEM_LIMIT = _build.SMEM_LIMIT

launches = 0


def _pow2(x: int) -> int:
    return 1 << max(x - 1, 0).bit_length()


def smem_bytes(d: int, tile_r: int, k: int) -> int:
    """Shared memory one CTA needs (mirrors ``smem_bytes`` in the .cu)."""
    return _pow2(k + tile_r) * 8 + (d + tile_r + 4 * k) * 4


def norms_gemm_dists(qv: torch.Tensor, vecs: torch.Tensor, xn: torch.Tensor
                     ) -> torch.Tensor:
    """Squared L2 via norms+GEMM: ``max((‖q‖² − 2·q·x) + ‖x‖², 0)``.

    qv (..., D) against row blocks vecs (..., R, D) with precomputed row
    norms xn (..., R) -> (..., R) f32, in the reference's association order.
    """
    qn = torch.sum(qv * qv, dim=-1)
    dots = torch.sum(qv[..., None, :] * vecs, dim=-1)
    return torch.clamp_min((qn[..., None] - 2.0 * dots) + xn, 0.0)


def _check(base, q, cand_ids, xn, k, tile_r):
    _build.check_args({"base": (base, torch.float32, 2),
                       "q": (q, torch.float32, 2),
                       "cand_ids": (cand_ids, torch.int32, 2),
                       "xn": (xn, torch.float32, 2)}, base.device)
    n, d = base.shape
    qq, rp = cand_ids.shape
    if q.shape != (qq, d) or xn.shape != (qq, rp):
        raise ValueError(f"q {tuple(q.shape)} / xn {tuple(xn.shape)}: want "
                         f"({qq}, {d}) / ({qq}, {rp})")
    if tile_r < 1 or rp % tile_r:
        raise ValueError(f"tile_r={tile_r} must divide Rp={rp} (pad with -1)")
    if k < 1:
        raise ValueError(f"k={k} must be >= 1")
    if smem_bytes(d, tile_r, k) > SMEM_LIMIT:
        raise ValueError(f"D={d}, tile_r={tile_r}, k={k} need "
                         f"{smem_bytes(d, tile_r, k)} B of shared memory")


def rerank_stream_topk_plain(base, q, cand_ids, xn, *, k: int, tile_r: int
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch, same arguments and result.

    Folding chunks into a running top-k with running entries first and
    first-occurrence extraction yields the stable ascending order over all
    candidate positions, so one stable sort reproduces ``_merge_topk``.
    """
    qq, rp = cand_ids.shape
    rows = base[torch.clamp_min(cand_ids, 0).long()]            # (Q, Rp, D)
    d = norms_gemm_dists(q, rows, xn)
    d = torch.where(cand_ids >= 0, d, torch.inf)
    if k > rp:
        d = torch.nn.functional.pad(d, (0, k - rp), value=torch.inf)
    vals, pos = torch.sort(d, dim=-1, stable=True)
    vals = vals[:, :k].contiguous()
    pos = torch.where(torch.isfinite(vals), pos[:, :k].to(torch.int32), -1)
    return vals, pos.contiguous()


def rerank_stream_topk(base: torch.Tensor, q: torch.Tensor,
                       cand_ids: torch.Tensor, xn: torch.Tensor, *, k: int,
                       tile_r: int = TILE_R
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Gather-free exact re-rank: (N, D) f32 base in place + (Q, Rp) i32
    candidate ids (-1 = pad, ids < N) + (Q, Rp) f32 ‖x‖² of each candidate
    -> (vals (Q, k) f32 ascending, pos (Q, k) i32 positions into cand_ids,
    -1 = absent). Rp must be a ``tile_r`` multiple.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise. Inputs must be contiguous, of the stated dtypes, on one device.
    """
    global launches
    _check(base, q, cand_ids, xn, k, tile_r)
    dev = base.device
    if dev.type == "cpu":
        return rerank_stream_topk_plain(base, q, cand_ids, xn, k=k,
                                        tile_r=tile_r)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    n, d = base.shape
    qq, rp = cand_ids.shape
    vals = torch.empty((qq, k), dtype=torch.float32, device=dev)
    pos = torch.empty((qq, k), dtype=torch.int32, device=dev)
    if qq == 0:
        return vals, pos
    lib = _build.load_library()
    with torch.cuda.device(dev):
        err = lib.repro_rerank_stream_topk(
            base.data_ptr(), q.data_ptr(), cand_ids.data_ptr(), xn.data_ptr(),
            qq, n, d, rp, tile_r, k, vals.data_ptr(), pos.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "rerank_stream_topk")
    launches += 1
    return vals, pos

"""K2: gather-free exact re-rank with a running top-k.

Replaces the TPU kernel ``repro/kernels/rerank_kernel.py::
rerank_stream_topk`` (Pallas body ``_rerank_kernel``, merge ``_merge_topk``,
distance ``norms_gemm_dists``); the CUDA source is
``csrc/rerank_stream_topk.cu``. It is bound by memory on the H100: each
candidate row (D*4 bytes, gathered by id from the in-place base) is read
once for 2*D flops, but at the serving shapes its time is a chain of
latencies (ids, rows, merge). One CTA per query: each warp issues the loads
of up to 8 candidate rows before it reduces any, with the next batch's ids
fetched ahead, and each chunk is folded into the running top-k by rank
(each 64-bit (distance bits, position) key counts the keys below it) while
the next chunk's rows are in flight: one barrier a chunk, no sort.

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


def smem_bytes(d: int, tile_r: int, k: int) -> int:
    """Shared memory one CTA needs (mirrors ``smem_bytes`` and
    ``repro_rerank_stream_topk_smem`` in the .cu): the running top-k's
    64-bit keys and a chunk's f32 distances, each double-buffered; D does
    not enter (q is read through the cache, not staged)."""
    return 2 * k * 8 + 2 * tile_r * 4


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
    _build.check_smem("repro_rerank_stream_topk_smem", d, tile_r, k,
                      what=f"D={d}, tile_r={tile_r}, k={k}")
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

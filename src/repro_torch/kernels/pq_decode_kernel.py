"""K8: one-token attention against the 4-bit PQ KV cache.

Replaces the plain-JAX function ``repro/models/kvcache.py::
pq_decode_attention`` (no ``pallas_call``: XLA's gather, masked online
softmax and value decode over 2,048-position chunks); the CUDA source is
``csrc/pq_decode_attention.cu``. The torch glue in
``models/kvcache.py::pq_decode_attention`` builds the inner-product LUTs
and quantizes them; the kernel scores each live position's key codes
against them with K1's row sum (i32 sums, then ``scale * acc + bias``),
runs a softmax in f32 and accumulates the decoded value rows. Dead
positions (past ``position[b]``) add exactly 0 in the reference and are
never read. Bound by memory on the H100: the live positions' codes.

The kernel is two launches a call. The split pass runs one CTA a (batch
row, KV head, ``SPLIT``-position split of the cache): ``ceil(Smax /
SPLIT)`` splits, a function of the static shapes alone and never of
``position``, so a captured decode graph replays one grid while the
position moves. Each live CTA writes its split's max, sum and value sum
a head to an f32 workspace; a split past the position writes the empty
partial. The combine pass, one CTA a (batch row, query head), scales the
live splits' partials to their common max and divides. Without atomics
the result is deterministic. The bound is bytes, but what sets the time
is latency: the split gives every SM CTAs to switch between, and no CTA
walks more than one 256-position tile.

Beside the kernel: ``pq_decode_plain``, the same function in plain
PyTorch in the reference's chunked order and casts (the CPU path and the
on-card reference) or, with ``split=``, in the kernel's split-and-combine
order; the integer and float ADC stages it is built from (``adc_sums``,
``adc_scores``), ``decode_kv``, and ``launches``, the count of kernel
calls (one a call, both passes together).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

launches = 0

# mirrors of the .cu's constants
THREADS = 256
SPLIT = 256           # positions a split of the split pass
MAX_G = 12
_WARPS = THREADS // 32


def _align16(x: int) -> int:
    return (x + 15) & ~15


def n_splits(smax: int) -> int:
    return -(-smax // SPLIT)


def smem_bytes(g: int, m: int, hd: int, q8: bool) -> int:
    """Shared memory one CTA of the split pass needs (mirrors ``layout``
    in the .cu, which exports it as ``repro_pq_decode_attention_smem``):
    the g LUTs, the value codebook as f32 in rows of a multiple of 32
    words, the split's K codes (or the product's group sums, which reuse
    them) and V codes in rows of an odd count of 16-byte units, its p, the
    max and sum partials."""
    dsub = hd // m
    units = hd // (2 if dsub % 2 == 0 else 1)
    rows = SPLIT * 16 * ((-(-(m // 2) // 16)) | 1)
    sums = (THREADS // units) * g * hd * 4
    return (_align16(g * m * 16 * (1 if q8 else 4))
            + _align16(16 * ((hd + 31) & ~31) * 4) + _align16(max(rows, sums))
            + _align16(rows) + _align16(SPLIT * g * 4)
            + _align16(2 * _WARPS * g * 4))


def combine_smem_bytes(smax: int) -> int:
    """Shared memory one CTA of the combine pass needs (mirrors the .cu's
    ``repro_pq_decode_combine_smem``): a weight a split and the sum."""
    return _align16((n_splits(smax) + 1) * 4)


def unpack_codes(packed: torch.Tensor) -> torch.Tensor:
    """(..., M//2) u8 -> (..., M) int64 codes, lo nibble = even m."""
    lo = (packed & 0xF).long()
    hi = ((packed >> 4) & 0xF).long()
    return torch.stack([lo, hi], dim=-1).reshape(*packed.shape[:-1], -1)


def decode_kv(packed: torch.Tensor, cb: torch.Tensor) -> torch.Tensor:
    """packed: (..., KV, M//2) u8; cb: (KV, M, 16, dsub) -> (..., KV, hd)
    in cb's dtype."""
    codes = unpack_codes(packed)                          # (..., KV, M)
    kv, m, _, dsub = cb.shape
    lead = codes.shape[:-2]
    cbx = cb.expand(*lead, kv, m, 16, dsub)
    idx = codes[..., None, None].expand(*lead, kv, m, 1, dsub)
    gathered = torch.gather(cbx, -2, idx)[..., 0, :]      # (..., KV, M, dsub)
    return gathered.reshape(*packed.shape[:-1], -1)


def _codes_bkmc(packed: torch.Tensor) -> torch.Tensor:
    """(B, C, KV, M//2) -> (B, KV, 1, M, C) int64 codes."""
    return unpack_codes(packed).permute(0, 2, 3, 1)[:, :, None]


def adc_sums(table_q8: torch.Tensor, packed: torch.Tensor) -> torch.Tensor:
    """The integer stage: (B, KV, g, M, 16) u8 x (B, C, KV, M//2) u8 ->
    (B, KV, g, C) i32 sums of the LUT entries the codes pick."""
    codes = _codes_bkmc(packed)
    b, kv, g, m, _ = table_q8.shape
    t = table_q8.to(torch.int32)
    idx = codes.expand(b, kv, g, m, codes.shape[-1])
    return torch.gather(t, -1, idx).sum(-2, dtype=torch.int32)


def adc_scores(table: torch.Tensor, scale, bias, packed: torch.Tensor
               ) -> torch.Tensor:
    """(B, KV, g, C) f32 scores: ``scale * sums + bias`` for a u8 table
    (scale, summed bias (B, KV, g)), else the f32 table's sums, added in
    the kernel's order (so that its scores equal these bit for bit)."""
    if table.dtype == torch.uint8:
        acc = adc_sums(table, packed)
        return scale[..., None] * acc.float() + bias[..., None]
    codes = _codes_bkmc(packed)
    b, kv, g, m, _ = table.shape
    idx = codes.expand(b, kv, g, m, codes.shape[-1])
    vals = torch.gather(table, -1, idx)                    # (B, KV, g, M, C)
    # the kernel's order: sub-space 0, 1, ..., M - 1, one f32 add each
    acc = vals[..., 0, :].clone()
    for j in range(1, m):
        acc += vals[..., j, :]
    return acc


def _check(table, scale, bias, k_codes, v_codes, v_cb, position) -> None:
    q8 = table.dtype == torch.uint8
    dev = table.device
    args = {"table": (table, torch.uint8 if q8 else torch.float32, 5),
            "k_codes": (k_codes, torch.uint8, 4),
            "v_codes": (v_codes, torch.uint8, 4),
            "v_cb": (v_cb, v_cb.dtype, 4),
            "position": (position, torch.int32, 1)}
    if q8:
        args["scale"] = (scale, torch.float32, 3)
        args["bias"] = (bias, torch.float32, 3)
    _build.check_args(args, dev)
    if v_cb.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"v_cb: want f32 or bf16, got {v_cb.dtype}")
    b, kv, g, m, k = table.shape
    if k != 16 or m % 2 or m < 2:
        raise ValueError(f"table {tuple(table.shape)}: want (B, KV, g, M, 16)"
                         " with M even")
    if k_codes.shape != v_codes.shape or k_codes.shape[0] != b or \
            k_codes.shape[2] != kv or k_codes.shape[3] != m // 2:
        raise ValueError(f"codes {tuple(k_codes.shape)} / "
                         f"{tuple(v_codes.shape)} do not match the table "
                         f"{tuple(table.shape)}")
    if v_cb.shape[:3] != (kv, m, 16):
        raise ValueError(f"v_cb {tuple(v_cb.shape)}: want ({kv}, {m}, 16, "
                         "dsub)")
    if position.shape != (b,):
        raise ValueError(f"position {tuple(position.shape)}: want ({b},)")
    if q8 and (scale.shape != (b, kv, g) or bias.shape != (b, kv, g)):
        raise ValueError("scale and bias must be (B, KV, g)")


def pq_decode_plain(table, scale, bias, k_codes, v_codes, v_cb, position,
                    *, chunk: int, out_dtype: torch.dtype,
                    split: int | None = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch, in the reference's order:
    an online softmax over ``chunk``-position chunks of the whole cache,
    dead positions masked to -inf, p cast to the codebook's type for each
    chunk's product. Returns (B, KV * g, hd) in ``out_dtype``.

    With ``split`` (an int; ``chunk`` is then unused), the kernel's order
    instead: each ``split``-position split of the cache (the last one
    ragged where Smax is not a multiple) takes its own max m_j, sum l_j
    and value sum acc_j, p rounded to the codebook's type at m_j and the
    product in f32; then the splits are scaled to their common max m*,
    ``sum e^(m_j - m*) acc_j / max(sum e^(m_j - m*) l_j, 1e-20)``."""
    if split is not None:
        return _plain_split(table, scale, bias, k_codes, v_codes, v_cb,
                            position, split, out_dtype)
    b, smax, kv, _ = k_codes.shape
    g = table.shape[2]
    hd = v_cb.shape[1] * v_cb.shape[3]
    dev = table.device
    m = torch.full((b, kv, g), float("-inf"), device=dev)
    l = torch.zeros((b, kv, g), device=dev)
    acc = torch.zeros((b, kv, g, hd), device=dev)
    for i in range(smax // chunk):
        kc = k_codes[:, i * chunk:(i + 1) * chunk]
        vc = v_codes[:, i * chunk:(i + 1) * chunk]
        s = adc_scores(table, scale, bias, kc)              # (B, KV, g, C)
        pos = i * chunk + torch.arange(chunk, device=dev)
        valid = pos[None, :] <= position[:, None].long()     # (B, C)
        s = torch.where(valid[:, None, None, :], s, float("-inf"))
        mj = torch.maximum(m, s.amax(-1))
        mj_safe = torch.where(torch.isfinite(mj), mj, 0.0)
        p = torch.exp(s - mj_safe[..., None])
        corr = torch.exp(torch.where(torch.isfinite(m), m - mj_safe,
                                     float("-inf")))
        l = l * corr + p.sum(-1)
        vh = decode_kv(vc, v_cb)                             # (B, C, KV, hd)
        acc = acc * corr[..., None] + torch.einsum(
            "bkgc,bckp->bkgp", p.to(vh.dtype), vh).float()
        m = mj
    out = acc / torch.clamp_min(l, 1e-20)[..., None]
    return out.reshape(b, kv * g, hd).to(out_dtype)


def _plain_split(table, scale, bias, k_codes, v_codes, v_cb, position,
                 split: int, out_dtype: torch.dtype) -> torch.Tensor:
    b, smax, kv, _ = k_codes.shape
    g = table.shape[2]
    hd = v_cb.shape[1] * v_cb.shape[3]
    dev = table.device
    ms, ls, accs = [], [], []
    for s0 in range(0, smax, split):
        kc = k_codes[:, s0:s0 + split]
        vc = v_codes[:, s0:s0 + split]
        s = adc_scores(table, scale, bias, kc)              # (B, KV, g, C)
        pos = s0 + torch.arange(kc.shape[1], device=dev)
        valid = pos[None, :] <= position[:, None].long()     # (B, C)
        s = torch.where(valid[:, None, None, :], s, float("-inf"))
        mj = s.amax(-1)                          # -inf for a dead split
        p = torch.exp(s - torch.where(torch.isfinite(mj), mj, 0.0)[..., None])
        vh = decode_kv(vc, v_cb)                             # (B, C, KV, hd)
        ms.append(mj)
        ls.append(p.sum(-1))
        accs.append(torch.einsum("bkgc,bckp->bkgp", p.to(vh.dtype).float(),
                                 vh.float()))
    m = torch.stack(ms)                                  # (n, B, KV, g)
    top = m.amax(0)
    w = torch.exp(m - torch.where(torch.isfinite(top), top, 0.0))
    l = (w * torch.stack(ls)).sum(0)
    acc = (w[..., None] * torch.stack(accs)).sum(0)
    out = acc / torch.clamp_min(l, 1e-20)[..., None]
    return out.reshape(b, kv * g, hd).to(out_dtype)


def _on_meta(b, kv, g, m, hd, smax, q8, v_cb, out_dtype) -> torch.Tensor:
    """The dry-run's K8: the shared-memory checks by the mirrors, one
    launch's cost recorded, an empty (B, KV * g, hd) output on meta."""
    from repro_torch.launch import cost_analysis
    for what, need in ((f"g={g}, M={m}, head_dim={hd}",
                        smem_bytes(g, m, hd, q8)),
                       (f"Smax={smax}", combine_smem_bytes(smax))):
        if need > _build.SMEM_LIMIT:
            raise ValueError(f"{what} needs {need} B of shared memory, more "
                             f"than the {_build.SMEM_LIMIT} B a block can "
                             "get")
    counter = cost_analysis.active()
    live = smax
    if counter is not None and counter.live_positions is not None:
        live = min(counter.live_positions, smax)
    cost_analysis.record_kernel(
        "pq_decode_attention", b=b, kv=kv, g=g, m=m, head_dim=hd, live=live,
        q8=q8, cb_itemsize=v_cb.element_size(),
        out_itemsize=out_dtype.itemsize)
    return torch.empty((b, kv * g, hd), dtype=out_dtype, device="meta")


def pq_decode(table: torch.Tensor, scale, bias, k_codes: torch.Tensor,
              v_codes: torch.Tensor, v_cb: torch.Tensor,
              position: torch.Tensor, *, chunk: int,
              out_dtype: torch.dtype, scores: torch.Tensor | None = None
              ) -> torch.Tensor:
    """(B, KV * g, hd) attention outputs of one token a batch row against
    the PQ cache. ``table`` is (B, KV, g, M, 16) u8 (``quantize_q8``, with
    ``scale`` and summed ``bias`` (B, KV, g) f32) or f32 (scale and bias
    None); ``k_codes``/``v_codes`` (B, Smax, KV, M//2) u8; ``v_cb`` (KV, M,
    16, dsub) bf16 or f32; ``position`` (B,) i32. ``chunk`` is the plain
    version's chunk (the kernel walks the cache in its own ``SPLIT``-
    position splits).

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise. ``scores`` (CUDA only), a (B, KV, g, Smax) f32 tensor, gets
    each live position's score from the kernel (for checks).

    Meta tensors (the dry-run, ``launch/dryrun.py``) compute nothing: the
    kernel's limits and both passes' shared memory are checked through
    the Python mirrors (no library is loaded), the cost of one launch is
    recorded on the active ``launch.cost_analysis`` counter (its live
    positions, or all Smax), and an empty output of the kernel's shape and
    dtype comes back.
    """
    global launches
    _check(table, scale, bias, k_codes, v_codes, v_cb, position)
    dev = table.device
    if dev.type == "cpu":
        if scores is not None:
            raise ValueError("scores is an output of the CUDA kernel only")
        return pq_decode_plain(table, scale, bias, k_codes, v_codes, v_cb,
                               position, chunk=chunk, out_dtype=out_dtype)
    if dev.type not in ("cuda", "meta"):
        raise ValueError(f"unsupported device {dev}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"out_dtype: want f32 or bf16, got {out_dtype}")
    b, kv, g, m, _ = table.shape
    smax = k_codes.shape[1]
    dsub = v_cb.shape[3]
    hd = m * dsub
    q8 = table.dtype == torch.uint8
    if g > MAX_G or hd > THREADS:
        raise ValueError(f"g={g} (at most {MAX_G}) and head_dim={hd} (at "
                         f"most {THREADS}) exceed what the kernel takes")
    if dev.type == "meta":
        if scores is not None:
            raise ValueError("scores is an output of the CUDA kernel only")
        return _on_meta(b, kv, g, m, hd, smax, q8, v_cb, out_dtype)
    _build.check_smem("repro_pq_decode_attention_smem", g, m, hd, int(q8),
                      what=f"g={g}, M={m}, head_dim={hd}")
    _build.check_smem("repro_pq_decode_combine_smem", smax,
                      what=f"Smax={smax}")
    if scores is not None:
        _build.check_args({"scores": (scores, torch.float32, 4)}, dev)
        if scores.shape != (b, kv, g, smax):
            raise ValueError(f"scores {tuple(scores.shape)}: want "
                             f"{(b, kv, g, smax)}")
    out = torch.empty((b, kv * g, hd), dtype=out_dtype, device=dev)
    # the split pass's (m_j, l_j, acc_j) a (row, head, split); inside a
    # capture, from the graph's pool
    work = torch.empty((b, kv, g, n_splits(smax), hd + 2),
                       dtype=torch.float32, device=dev)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        err = lib.repro_pq_decode_attention(
            table.data_ptr(), scale.data_ptr() if q8 else None,
            bias.data_ptr() if q8 else None, k_codes.data_ptr(),
            v_codes.data_ptr(), v_cb.data_ptr(), position.data_ptr(), b, kv,
            g, m, dsub, smax, int(q8), int(v_cb.dtype == torch.bfloat16),
            int(out_dtype == torch.bfloat16), out.data_ptr(),
            scores.data_ptr() if scores is not None else None,
            work.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "pq_decode_attention")
    launches += 1
    return out

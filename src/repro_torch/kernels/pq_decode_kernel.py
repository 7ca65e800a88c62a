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

The two passes are also entry points of their own, K8's sharded mode
for a cache sharded on its positions over several ranks
(``models/kvcache.py``): ``pq_decode_split`` runs the split pass over a
rank's local positions, its live mask at ``pos_offset + local index``,
and returns the rank's partials; ``pq_decode_combine`` runs the combine
pass over partials concatenated along the split axis, skipping the dead
splits (it reads no position). Where every rank's length is a multiple
of ``SPLIT``, the ranks' partials in rank order are the one-rank call's
live ones, and the combine's output is ``pq_decode``'s bit for bit.

K8's sub-space mode is two more entry points, for a cache sharded on
its sub-spaces ("pq_m") over several ranks, each rank holding the codes
and codebooks of M / n sub-spaces and its slice of every query's
head_dim (``models/kvcache.py``). ``pq_decode_scores`` runs the scoring
alone over the rank's sub-spaces: the i32 sums ``sum_m LUT_q8[m,
code_m]`` a (row, query head, live position), one CTA a (row, KV head,
split) as the split pass (0 at a dead position). The ranks' sums are
all-reduced, exactly, into the one-rank kernel's sums. ``pq_decode_values``
takes the reduced sums, the scale and the summed bias of the whole LUT,
and runs the split pass's softmax and value sum over the rank's
sub-spaces (its head_dim slice): the split partials that
``pq_decode_combine`` takes. It is the split pass's own code fed sums in
place of codes, so the scores and the softmax are the one-rank K8's bit
for bit; the value sums walk fewer dims a thread, in another order.

Beside the kernel: ``pq_decode_plain``, the same function in plain
PyTorch in the reference's chunked order and casts (the CPU path and the
on-card reference) or, with ``split=``, in the kernel's split-and-combine
order (``plain_partials`` then ``plain_combine``, the two passes' plain
versions); the integer and float ADC stages it is built from
(``adc_sums``, ``adc_scores``), ``decode_kv``, the sub-space mode's
plain passes (``plain_scores``, ``plain_values``), and ``launches``, the
count of kernel calls (one a ``pq_decode`` call, both passes together;
one a ``pq_decode_split``, ``pq_decode_combine``, ``pq_decode_scores``
and ``pq_decode_values`` call), with ``launches_by``, the same calls by
entry point.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

launches = 0
launches_by: dict[str, int] = {}   # entry point -> its launches


def _launched(name: str) -> None:
    """One launch of the entry point ``name``, on both counts."""
    global launches
    launches += 1
    launches_by[name] = launches_by.get(name, 0) + 1

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


def scores_smem_bytes(g: int, m: int) -> int:
    """Shared memory one CTA of the scoring pass needs (mirrors the .cu's
    ``repro_pq_decode_scores_smem``): the g u8 LUTs of its M sub-spaces
    and the split's K code rows."""
    return (_align16(g * m * 16)
            + _align16(SPLIT * 16 * ((-(-(m // 2) // 16)) | 1)))


def combine_splits_smem_bytes(nsplit: int) -> int:
    """Shared memory one CTA of the combine pass needs over ``nsplit``
    splits (mirrors the .cu's ``repro_pq_decode_combine_splits_smem``): a
    weight a split and the sum."""
    return _align16((nsplit + 1) * 4)


def combine_smem_bytes(smax: int) -> int:
    """The combine pass's shared memory over the splits of Smax (mirrors
    ``repro_pq_decode_combine_smem``)."""
    return combine_splits_smem_bytes(n_splits(smax))


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
    return plain_combine(plain_partials(table, scale, bias, k_codes, v_codes,
                                        v_cb, position, split=split),
                         out_dtype=out_dtype)


def plain_partials(table, scale, bias, k_codes, v_codes, v_cb, position, *,
                   split: int = SPLIT, pos_offset: int = 0) -> torch.Tensor:
    """The split pass in plain PyTorch: (B, KV, g, ceil(Smax / split), hd
    + 2) f32, each ``split``-position split's max m_j (-inf where no
    position is live), sum l_j and value sum acc_j a (row, KV head, query
    head), as the kernel writes them; p rounded to the codebook's type at
    m_j, the product in f32. Local position i is global position
    ``pos_offset + i`` (a rank's shard of the cache)."""
    return _partials(lambda s0, s1: adc_scores(table, scale, bias,
                                               k_codes[:, s0:s1]),
                     v_codes, v_cb, position, split, pos_offset)


def _partials(scores_of, v_codes, v_cb, position, split: int,
              pos_offset: int) -> torch.Tensor:
    """The split pass's partials with the scores of positions [s0, s1)
    from ``scores_of(s0, s1)`` (B, KV, g, s1 - s0) f32."""
    smax = v_codes.shape[1]
    dev = v_codes.device
    parts = []
    for s0 in range(0, smax, split):
        vc = v_codes[:, s0:s0 + split]
        s = scores_of(s0, s0 + vc.shape[1])                 # (B, KV, g, C)
        pos = pos_offset + s0 + torch.arange(vc.shape[1], device=dev)
        valid = pos[None, :] <= position[:, None].long()     # (B, C)
        s = torch.where(valid[:, None, None, :], s, float("-inf"))
        mj = s.amax(-1)                          # -inf for a dead split
        p = torch.exp(s - torch.where(torch.isfinite(mj), mj, 0.0)[..., None])
        vh = decode_kv(vc, v_cb)                             # (B, C, KV, hd)
        acc = torch.einsum("bkgc,bckp->bkgp", p.to(vh.dtype).float(),
                           vh.float())
        parts.append(torch.cat([mj[..., None], p.sum(-1)[..., None], acc],
                               dim=-1))
    return torch.stack(parts, dim=3)


def plain_scores(table_q8: torch.Tensor, k_codes: torch.Tensor,
                 position: torch.Tensor) -> torch.Tensor:
    """The scoring pass in plain PyTorch: (B, KV, g, Smax) i32, the sums
    of the u8 LUT entries of the given sub-spaces that each live
    position's codes pick (``adc_sums``), 0 at a dead position."""
    sums = adc_sums(table_q8, k_codes)
    live = (torch.arange(k_codes.shape[1], device=k_codes.device)[None]
            <= position[:, None].long())
    return torch.where(live[:, None, None], sums, 0)


def plain_values(sums: torch.Tensor, scale, bias, v_codes: torch.Tensor,
                 v_cb: torch.Tensor, position: torch.Tensor, *,
                 split: int = SPLIT) -> torch.Tensor:
    """The value pass in plain PyTorch: ``plain_partials``'s partials with
    the scores ``scale * sums + bias`` of the whole LUT's reduced i32
    ``sums`` (B, KV, g, Smax), the value sums over the given sub-spaces'
    codebooks (a slice of head_dim)."""
    return _partials(lambda s0, s1: scale[..., None] * sums[..., s0:s1].float()
                     + bias[..., None], v_codes, v_cb, position, split, 0)


def plain_combine(work: torch.Tensor, *, out_dtype: torch.dtype
                  ) -> torch.Tensor:
    """The combine pass in plain PyTorch over (B, KV, g, n, hd + 2)
    partials: the splits scaled to their common max m*, ``sum e^(m_j -
    m*) acc_j / max(sum e^(m_j - m*) l_j, 1e-20)``, in split order; (B, KV
    * g, hd) in ``out_dtype``."""
    b, kv, g, _, hd2 = work.shape
    m = work[..., 0].movedim(3, 0).contiguous()          # (n, B, KV, g)
    ls = work[..., 1].movedim(3, 0).contiguous()
    accs = work[..., 2:].movedim(3, 0).contiguous()
    top = m.amax(0)
    w = torch.exp(m - torch.where(torch.isfinite(top), top, 0.0))
    l = (w * ls).sum(0)
    acc = (w[..., None] * accs).sum(0)
    out = acc / torch.clamp_min(l, 1e-20)[..., None]
    return out.reshape(b, kv * g, hd2 - 2).to(out_dtype)


def _on_meta(b, kv, g, m, hd, smax, q8, v_cb, out_dtype) -> torch.Tensor:
    """The dry-run's K8: the shared-memory checks by the mirrors, one
    launch's cost recorded, an empty (B, KV * g, hd) output on meta."""
    from repro_torch.launch import cost_analysis
    _meta_smem((f"g={g}, M={m}, head_dim={hd}", smem_bytes(g, m, hd, q8)),
               (f"Smax={smax}", combine_smem_bytes(smax)))
    cost_analysis.record_kernel(
        "pq_decode_attention", b=b, kv=kv, g=g, m=m, head_dim=hd,
        live=_meta_live(smax), q8=q8, cb_itemsize=v_cb.element_size(),
        out_itemsize=out_dtype.itemsize)
    return torch.empty((b, kv * g, hd), dtype=out_dtype, device="meta")


def _meta_smem(*needs) -> None:
    """The Python mirrors' check on meta: each (what, bytes) a CTA needs
    within what a block can get."""
    for what, need in needs:
        if need > _build.SMEM_LIMIT:
            raise ValueError(f"{what} needs {need} B of shared memory, more "
                             f"than the {_build.SMEM_LIMIT} B a block can "
                             "get")


def _meta_live(smax: int, offset: int = 0) -> int:
    """The live positions of the active counter among the ``smax`` from
    global position ``offset`` on (all ``smax`` without a count)."""
    from repro_torch.launch import cost_analysis
    counter = cost_analysis.active()
    if counter is not None and counter.live_positions is not None:
        return max(0, min(counter.live_positions - offset, smax))
    return smax


def _check_card(dev: torch.device, out_dtype: torch.dtype) -> None:
    if dev.type not in ("cuda", "meta"):
        raise ValueError(f"unsupported device {dev}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"out_dtype: want f32 or bf16, got {out_dtype}")


def _dims(table, k_codes, v_cb):
    """(b, kv, g, m, hd, smax, q8) of a checked call, within the
    kernel's limits."""
    b, kv, g, m, _ = table.shape
    hd = m * v_cb.shape[3]
    if g > MAX_G or hd > THREADS:
        raise ValueError(f"g={g} (at most {MAX_G}) and head_dim={hd} (at "
                         f"most {THREADS}) exceed what the kernel takes")
    return b, kv, g, m, hd, k_codes.shape[1], table.dtype == torch.uint8


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
    _check(table, scale, bias, k_codes, v_codes, v_cb, position)
    dev = table.device
    if dev.type == "cpu":
        if scores is not None:
            raise ValueError("scores is an output of the CUDA kernel only")
        return pq_decode_plain(table, scale, bias, k_codes, v_codes, v_cb,
                               position, chunk=chunk, out_dtype=out_dtype)
    _check_card(dev, out_dtype)
    b, kv, g, m, hd, smax, q8 = _dims(table, k_codes, v_cb)
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
            g, m, v_cb.shape[3], smax, int(q8),
            int(v_cb.dtype == torch.bfloat16),
            int(out_dtype == torch.bfloat16), out.data_ptr(),
            scores.data_ptr() if scores is not None else None,
            work.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "pq_decode_attention")
    _launched("pq_decode_attention")
    return out


def pq_decode_split(table: torch.Tensor, scale, bias, k_codes: torch.Tensor,
                    v_codes: torch.Tensor, v_cb: torch.Tensor,
                    position: torch.Tensor, *, pos_offset: int = 0
                    ) -> torch.Tensor:
    """K8's split pass alone over a shard of the cache whose local
    position i is global position ``pos_offset + i``: (B, KV, g,
    ceil(Smax_local / SPLIT), hd + 2) f32 partials (m_j, l_j, acc_j); a
    split with no live position has m_j = -inf and l_j = 0, and its acc_j
    is not written on the card. Arguments as ``pq_decode``'s, the codes
    the shard's. CPU tensors take ``plain_partials``; CUDA tensors launch
    the split pass or raise; meta tensors record the pass's cost."""
    _check(table, scale, bias, k_codes, v_codes, v_cb, position)
    dev = table.device
    if dev.type == "cpu":
        return plain_partials(table, scale, bias, k_codes, v_codes, v_cb,
                              position, pos_offset=pos_offset)
    _check_card(dev, torch.float32)
    b, kv, g, m, hd, smax, q8 = _dims(table, k_codes, v_cb)
    shape = (b, kv, g, n_splits(smax), hd + 2)
    if dev.type == "meta":
        from repro_torch.launch import cost_analysis
        _meta_smem((f"g={g}, M={m}, head_dim={hd}",
                    smem_bytes(g, m, hd, q8)))
        cost_analysis.record_kernel(
            "pq_decode_split", b=b, kv=kv, g=g, m=m, head_dim=hd,
            live=_meta_live(smax, pos_offset), nsplit=shape[3], q8=q8,
            cb_itemsize=v_cb.element_size())
        return torch.empty(shape, dtype=torch.float32, device="meta")
    _build.check_smem("repro_pq_decode_attention_smem", g, m, hd, int(q8),
                      what=f"g={g}, M={m}, head_dim={hd}")
    work = torch.empty(shape, dtype=torch.float32, device=dev)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        err = lib.repro_pq_decode_split(
            table.data_ptr(), scale.data_ptr() if q8 else None,
            bias.data_ptr() if q8 else None, k_codes.data_ptr(),
            v_codes.data_ptr(), v_cb.data_ptr(), position.data_ptr(), b, kv,
            g, m, v_cb.shape[3], smax, int(pos_offset), int(q8),
            int(v_cb.dtype == torch.bfloat16), work.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "pq_decode_split")
    _launched("pq_decode_split")
    return work


def pq_decode_combine(work: torch.Tensor, *, out_dtype: torch.dtype
                      ) -> torch.Tensor:
    """K8's combine pass alone over (B, KV, g, n, hd + 2) f32 partials
    (``pq_decode_split``'s, of one or several shards concatenated on the
    split axis in position order): (B, KV * g, hd) in ``out_dtype``. The
    dead splits (m_j = -inf) are skipped. CPU tensors take
    ``plain_combine``; CUDA tensors launch the combine pass or raise; meta
    tensors record the pass's cost."""
    _build.check_args({"work": (work, torch.float32, 5)}, work.device)
    b, kv, g, nsplit, hd2 = work.shape
    if hd2 < 3:
        raise ValueError(f"work {tuple(work.shape)}: want (B, KV, g, n, hd "
                         "+ 2)")
    dev = work.device
    if dev.type == "cpu":
        return plain_combine(work, out_dtype=out_dtype)
    _check_card(dev, out_dtype)
    out_shape = (b, kv * g, hd2 - 2)
    if dev.type == "meta":
        from repro_torch.launch import cost_analysis
        _meta_smem((f"{nsplit} splits", combine_splits_smem_bytes(nsplit)))
        cost_analysis.record_kernel(
            "pq_decode_combine", b=b, kv=kv, g=g, head_dim=hd2 - 2,
            nsplit=nsplit, live_splits=n_splits(_meta_live(nsplit * SPLIT)),
            out_itemsize=out_dtype.itemsize)
        return torch.empty(out_shape, dtype=out_dtype, device="meta")
    _build.check_smem("repro_pq_decode_combine_splits_smem", nsplit,
                      what=f"{nsplit} splits")
    out = torch.empty(out_shape, dtype=out_dtype, device=dev)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        err = lib.repro_pq_decode_combine(
            work.data_ptr(), b, kv, g, hd2 - 2, nsplit,
            int(out_dtype == torch.bfloat16), out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "pq_decode_combine")
    _launched("pq_decode_combine")
    return out


def _check_sub(table, k_codes, position) -> None:
    args = {"table": (table, torch.uint8, 5),
            "k_codes": (k_codes, torch.uint8, 4),
            "position": (position, torch.int32, 1)}
    _build.check_args(args, table.device)
    b, kv, g, m, k = table.shape
    if k != 16 or m % 2 or m < 2:
        raise ValueError(f"table {tuple(table.shape)}: want (B, KV, g, M, 16)"
                         " with M even")
    if k_codes.shape[0] != b or k_codes.shape[2] != kv or \
            k_codes.shape[3] != m // 2:
        raise ValueError(f"k_codes {tuple(k_codes.shape)} do not match the "
                         f"table {tuple(table.shape)}")
    if position.shape != (b,):
        raise ValueError(f"position {tuple(position.shape)}: want ({b},)")
    if g > MAX_G:
        raise ValueError(f"g={g}: at most {MAX_G}")


def pq_decode_scores(table_q8: torch.Tensor, k_codes: torch.Tensor,
                     position: torch.Tensor) -> torch.Tensor:
    """K8's scoring pass over the sub-spaces a rank holds: ``table_q8``
    (B, KV, g, M_r, 16) u8, the LUTs of those sub-spaces quantized with
    the whole LUT's scale; ``k_codes`` (B, Smax, KV, M_r / 2) u8, their
    codes; ``position`` (B,) i32. Returns (B, KV, g, Smax) i32, each live
    position's sum over the sub-spaces, 0 at a dead one. CPU tensors take
    ``plain_scores``; CUDA tensors launch the pass or raise; meta tensors
    record its cost."""
    _check_sub(table_q8, k_codes, position)
    dev = table_q8.device
    b, kv, g, m, _ = table_q8.shape
    smax = k_codes.shape[1]
    if dev.type == "cpu":
        return plain_scores(table_q8, k_codes, position)
    _check_card(dev, torch.float32)
    shape = (b, kv, g, smax)
    if dev.type == "meta":
        from repro_torch.launch import cost_analysis
        _meta_smem((f"g={g}, M={m}", scores_smem_bytes(g, m)))
        cost_analysis.record_kernel(
            "pq_decode_scores", b=b, kv=kv, g=g, m=m, smax=smax,
            live=_meta_live(smax))
        return torch.empty(shape, dtype=torch.int32, device="meta")
    _build.check_smem("repro_pq_decode_scores_smem", g, m,
                      what=f"g={g}, M={m}")
    sums = torch.empty(shape, dtype=torch.int32, device=dev)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        err = lib.repro_pq_decode_scores(
            table_q8.data_ptr(), k_codes.data_ptr(), position.data_ptr(), b,
            kv, g, m, smax, sums.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "pq_decode_scores")
    _launched("pq_decode_scores")
    return sums


def pq_decode_values(sums: torch.Tensor, scale: torch.Tensor,
                     bias: torch.Tensor, v_codes: torch.Tensor,
                     v_cb: torch.Tensor, position: torch.Tensor
                     ) -> torch.Tensor:
    """K8's value pass over the sub-spaces a rank holds: ``sums`` (B, KV,
    g, Smax) i32, the whole LUT's sums (the ranks' ``pq_decode_scores``
    all-reduced); ``scale`` and summed ``bias`` (B, KV, g) f32 of the
    whole LUT; ``v_codes`` (B, Smax, KV, M_r / 2) u8 and ``v_cb`` (KV, M_r,
    16, dsub) bf16 or f32, the rank's sub-spaces; ``position`` (B,) i32.
    Returns the split partials (B, KV, g, ceil(Smax / 256), M_r * dsub +
    2) f32 of the rank's head_dim slice, for ``pq_decode_combine``. CPU
    tensors take ``plain_values``; CUDA tensors launch the pass or raise;
    meta tensors record its cost."""
    args = {"sums": (sums, torch.int32, 4), "scale": (scale, torch.float32, 3),
            "bias": (bias, torch.float32, 3),
            "v_codes": (v_codes, torch.uint8, 4),
            "v_cb": (v_cb, v_cb.dtype, 4),
            "position": (position, torch.int32, 1)}
    dev = sums.device
    _build.check_args(args, dev)
    if v_cb.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"v_cb: want f32 or bf16, got {v_cb.dtype}")
    b, kv, g, smax = sums.shape
    m, dsub = v_cb.shape[1], v_cb.shape[3]
    hd = m * dsub
    if v_codes.shape != (b, smax, kv, m // 2) or v_cb.shape[0] != kv or \
            v_cb.shape[2] != 16 or m % 2:
        raise ValueError(f"v_codes {tuple(v_codes.shape)} / v_cb "
                         f"{tuple(v_cb.shape)} do not match the sums "
                         f"{tuple(sums.shape)}")
    if scale.shape != (b, kv, g) or bias.shape != (b, kv, g) or \
            position.shape != (b,):
        raise ValueError("scale and bias must be (B, KV, g), position (B,)")
    if g > MAX_G or hd > THREADS:
        raise ValueError(f"g={g} (at most {MAX_G}) and head_dim={hd} (at "
                         f"most {THREADS}) exceed what the kernel takes")
    if dev.type == "cpu":
        return plain_values(sums, scale, bias, v_codes, v_cb, position)
    _check_card(dev, torch.float32)
    shape = (b, kv, g, n_splits(smax), hd + 2)
    if dev.type == "meta":
        from repro_torch.launch import cost_analysis
        _meta_smem((f"g={g}, M={m}, head_dim={hd}",
                    smem_bytes(g, m, hd, True)))
        cost_analysis.record_kernel(
            "pq_decode_values", b=b, kv=kv, g=g, m=m, head_dim=hd,
            live=_meta_live(smax), nsplit=shape[3],
            cb_itemsize=v_cb.element_size())
        return torch.empty(shape, dtype=torch.float32, device="meta")
    _build.check_smem("repro_pq_decode_attention_smem", g, m, hd, 1,
                      what=f"g={g}, M={m}, head_dim={hd}")
    work = torch.empty(shape, dtype=torch.float32, device=dev)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        err = lib.repro_pq_decode_values(
            sums.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            v_codes.data_ptr(), v_cb.data_ptr(), position.data_ptr(), b, kv,
            g, m, dsub, smax, int(v_cb.dtype == torch.bfloat16),
            work.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "pq_decode_values")
    _launched("pq_decode_values")
    return work

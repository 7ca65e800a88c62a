"""Three-term roofline of one NVIDIA H100 (the port of
``repro/launch/roofline.py``).

    compute term    = counted FLOPs / the bf16 peak
    memory term     = compulsory bytes / the HBM rate
    collective term = wire bytes / the NVLink rate (0 on one card)

The reference divides XLA's per-device counts of a TPU pod's partitioned
step by a v5e chip's peaks; here the counts are those of
``launch/cost_analysis.py`` over the aten ops of one step on one card,
and the peaks the card's, named below. ``model_flops`` is the reference's
formula, copied.

Beside it, each of the port's kernels' own work as code (``kernel_cost``,
``kernel_bound_ms``): each input read once and each output written once;
an ADC look-up and add per (query or group, row, sub-space) as int8 work;
K2's distances and K8's value sums as f32 work outside the tensor cores.
Never the operations of a kernel's formulation (a one-hot product's 16x).
Nothing here touches a card: the numbers are arithmetic on shapes and
counts (the dry-run's come from the meta device by design, never as a
fallback from a card).
"""
from __future__ import annotations

from dataclasses import dataclass

# NVIDIA H100 80GB HBM3 (SXM), data sheet, dense rates, at its 700 W limit
DEVICE = "NVIDIA H100 80GB HBM3"
POWER_W = 700
PEAK_FLOPS = 989e12          # bf16 FLOP/s on the tensor cores
PEAK_INT8_OPS = 1979e12      # int8 OP/s on the tensor cores
PEAK_F32_FLOPS = 67e12       # f32 FLOP/s outside the tensor cores
HBM_BW = 3.35e12             # bytes/s of device memory
LINK_BW = 450e9              # bytes/s of NVLink, one direction
# the card's memory where no card is asked (the dry-run on the meta
# device): the data sheet's 80 GB. On the card, ``card_memory_bytes``
# reads the device's own total.
HBM_BYTES = 80 * 10**9


def card_memory_bytes(device=None) -> int:
    """The memory of the CUDA card ``device`` (default: the current one)
    as CUDA reports it."""
    import torch
    return torch.cuda.get_device_properties(
        device if device is not None else torch.cuda.current_device()
    ).total_memory


@dataclass
class Roofline:
    """The reference's fields, filled with one card's counts:
    ``hlo_flops_per_dev`` the counted FLOPs, ``hlo_bytes_per_dev`` the
    compulsory bytes (``cost_analysis.Costs.min_bytes``),
    ``wire_bytes_per_dev`` 0 on one card."""
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops_per_dev: float
    hlo_bytes_per_dev: float
    wire_bytes_per_dev: float
    model_flops_total: float
    collectives: dict

    @property
    def t_compute(self) -> float:
        return self.hlo_flops_per_dev / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.hlo_bytes_per_dev / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.wire_bytes_per_dev / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        """Roofline step time lower bound (no overlap assumption)."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / (counted FLOPs x chips): how much of the work
        done is the model's (remat, recompute, masked blocks waste)."""
        denom = self.hlo_flops_per_dev * self.chips
        return self.model_flops_total / denom if denom else 0.0

    @property
    def mfu_bound(self) -> float:
        """Model-FLOPs utilization at the roofline bound."""
        t = self.t_bound
        if t <= 0:
            return 0.0
        return self.model_flops_total / (self.chips * PEAK_FLOPS * t)

    def to_dict(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "hlo_flops_per_dev": self.hlo_flops_per_dev,
            "hlo_bytes_per_dev": self.hlo_bytes_per_dev,
            "wire_bytes_per_dev": self.wire_bytes_per_dev,
            "model_flops_total": self.model_flops_total,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_flops_ratio": self.useful_flops_ratio,
            "mfu_bound": self.mfu_bound,
            "collectives": self.collectives,
        }


def model_flops(cfg, kind: str, batch: int, seq: int) -> float:
    """Analytic MODEL_FLOPS: 6·N_active·D train, 2·N_active·D inference."""
    n_active = cfg.active_param_count()
    tokens = batch * seq if kind in ("train", "prefill") else batch
    mult = 6.0 if kind == "train" else 2.0
    flops = mult * n_active * tokens
    # causal attention term (counted like standard MFU accounting)
    if cfg.n_heads:
        hd = cfg.resolved_head_dim
        if kind in ("train", "prefill"):
            att = 2 * 2 * cfg.n_layers * batch * seq * seq / 2 * cfg.n_heads * hd
            att *= 3.0 if kind == "train" else 1.0
        else:  # decode: one query against `seq` keys
            att = 2 * 2 * cfg.n_layers * batch * seq * cfg.n_heads * hd
        if cfg.block_type == "mamba2" and cfg.shared_attn_every:
            att /= cfg.shared_attn_every
        elif cfg.block_type != "attn":
            att = 0.0
        flops += att
    return flops


# ---------------------------------------------------------------------------
# the kernels' own work
# ---------------------------------------------------------------------------

def _scan(g: int, m: int) -> int:
    """Bytes of ``g`` u8 LUTs of (M, 16)."""
    return g * m * 16


def _k1(*, g, m, kc, n_tiles, live_rows, lists, filter_bytes, group_rows):
    # the probed lists' live rows (occupied, passing the filter) read once,
    # each probed list's filter bytes and size, the LUTs and probe ids, a
    # (value, position) i32 pair for each of a tile's kc survivors
    nbytes = (live_rows * (m // 2) + lists * (filter_bytes + 4) + _scan(g, m)
              + g * 4 + 2 * g * n_tiles * kc * 4)
    return nbytes, group_rows * m * 2, PEAK_INT8_OPS


def _k2(*, q, d, rp, k, valid):
    # the valid candidates' f32 rows, the queries, the ids and norms, the
    # (distance, id) top-k written once; a multiply and an add a dimension
    nbytes = valid * d * 4 + q * d * 4 + 2 * q * rp * 4 + q * k * 8
    return nbytes, 2 * valid * d, PEAK_F32_FLOPS


def _k3(*, g, m, cap, lists, groups):
    # each distinct probed list read in place once, the LUTs and probe ids,
    # the (G, cap) i32 sums written
    nbytes = lists * cap * (m // 2) + _scan(g, m) + g * 4 + g * cap * 4
    return nbytes, groups * cap * m * 2, PEAK_INT8_OPS


def _k4(*, g, m, kc, tile, n_tiles, live_rows, tiles, group_rows):
    # only what was scanned: the live rows of each distinct (list, tile)
    # with its filter bytes and size; every LUT and a group's bound, scale
    # and bias; each tile's kc survivors and its skip flag
    nbytes = (live_rows * (m // 2) + tiles * (tile // 8 + 4) + _scan(g, m)
              + g * 16 + g * n_tiles * (kc * 8 + 4))
    return nbytes, group_rows * m * 2, PEAK_INT8_OPS


def _gathered(*, g, n, m):
    # K5 and K6 over the gathered (G, N, M/2) copy: codes, LUTs, sums
    return g * n * (m // 2) + _scan(g, m) + g * n * 4, g * n * m * 2, \
        PEAK_INT8_OPS


def _flat(*, q, n, m):
    # K7a and K7b: the (N, M/2) codes and Q LUTs read, (Q, N) sums written
    return _scan(q, m) + n * (m // 2) + q * n * 4, q * n * m * 2, \
        PEAK_INT8_OPS


def _k7c(*, q, n, m, block):
    # K7c: codes and LUTs read, a (min, row) pair a (query, block) written
    return _scan(q, m) + n * (m // 2) + 2 * q * (n // block) * 4, \
        q * n * m * 2, PEAK_INT8_OPS


def _k8(*, b, kv, g, m, head_dim, live, q8=True, cb_itemsize=2,
        out_itemsize=2):
    # the live positions' K and V codes, the LUTs (u8, with a scale and a
    # summed bias a row; or f32), the value codebook, the positions, the
    # output; int8 ADC look-ups and adds a (row, head, live position,
    # sub-space), and a multiply and an add in f32 a value element. The
    # two kinds of work run on different units, so their times add: the
    # ops are returned with the one rate that takes that sum.
    dsub = head_dim // m
    table = b * kv * g * m * 16 * (1 if q8 else 4)
    nbytes = (2 * b * live * kv * (m // 2) + table
              + (2 * 4 * b * kv * g if q8 else 0)
              + kv * m * 16 * dsub * cb_itemsize + 4 * b
              + b * kv * g * head_dim * out_itemsize)
    int_ops = b * kv * g * live * m * 2
    flops = b * kv * g * live * head_dim * 2
    ops = int_ops + flops
    seconds = int_ops / PEAK_INT8_OPS + flops / PEAK_F32_FLOPS
    return nbytes, ops, (ops / seconds if seconds else PEAK_F32_FLOPS)


KERNEL_COSTS = {
    "fastscan_stream_topk": _k1,
    "rerank_stream_topk": _k2,
    "fastscan_stream_grouped": _k3,
    "fastscan_stream_topk_prune": _k4,
    "fastscan_select_grouped": _gathered,
    "fastscan_onehot_mma_grouped": _gathered,
    "fastscan_select_flat": _flat,
    "fastscan_onehot_mma_flat": _flat,
    "fastscan_blockmin": _k7c,
    "pq_decode_attention": _k8,
}


def kernel_cost(name: str, **shape) -> tuple[int, int, float]:
    """(bytes, ops, peak) of one call of the kernel ``name`` (its entry in
    the kernels line) at ``shape``: the bytes it must move, its own
    operations and the rate of their type. Data-dependent counts (live
    rows, probed lists, scanned tiles, live positions) are this call's
    own: ``stream_counts`` and ``pruned_counts`` compute the scans'."""
    return KERNEL_COSTS[name](**shape)


def bound_ms(nbytes: float, ops: float, peak: float) -> tuple[float, str]:
    """The least time (ms) the card could take for ``nbytes`` moved and
    ``ops`` done at ``peak``, and which term binds."""
    t_b = nbytes / HBM_BW
    t_o = ops / peak
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"


def kernel_bound_ms(name: str, **shape) -> tuple[float, str]:
    """``bound_ms`` of ``kernel_cost(name, **shape)``."""
    return bound_ms(*kernel_cost(name, **shape))


def stream_counts(probes, sizes, cap: int, filter_bits=None) -> dict:
    """The data-dependent counts of a stream scan (K1, and K3 without a
    filter or sizes) over numpy ``probes`` (G,) (-1 = none), list
    ``sizes`` (nlist,) and the lists' packed ``filter_bits`` (nlist, W)
    u8 (little bit order; None = every row passes): the live rows of the
    distinct probed lists (``live_rows``), how many lists that is
    (``lists``), the live rows summed over the groups (``group_rows``) and
    the groups with a probe (``groups``)."""
    import numpy as np
    probes = np.asarray(probes)
    valid = probes[probes >= 0]
    live = np.arange(cap)[None, :] < np.asarray(sizes)[:, None]
    if filter_bits is not None:
        live &= np.unpackbits(np.asarray(filter_bits), axis=1,
                              bitorder="little")[:, :cap].astype(bool)
    distinct = np.unique(valid)
    return {"live_rows": int(live[distinct].sum()), "lists": int(distinct.size),
            "group_rows": int(live[valid].sum()), "groups": int(valid.size)}


def pruned_counts(probes, sizes, filter_bits, skipped, cap: int,
                  tile: int) -> dict:
    """K4's data-dependent counts: only the (group, tile) pairs it scanned
    (a probe, not ``skipped`` (G, cap / tile)): the live rows of the
    distinct (list, tile) pairs (``live_rows``), how many pairs
    (``tiles``), and the live rows summed over the scanned group tiles
    (``group_rows``)."""
    import numpy as np
    probes = np.asarray(probes)
    n_tiles = cap // tile
    scanned = (probes >= 0)[:, None] & ~np.asarray(skipped, bool)
    passing = np.unpackbits(np.asarray(filter_bits), axis=1,
                            bitorder="little")[:, :cap]
    live = passing & (np.arange(cap)[None, :] < np.asarray(sizes)[:, None])
    live_tile = live.reshape(len(live), n_tiles, tile).sum(-1)
    gi, ti = np.nonzero(scanned)
    pairs = np.unique(probes[gi] * n_tiles + ti)
    return {"live_rows": int(live_tile.reshape(-1)[pairs].sum()),
            "tiles": int(pairs.size),
            "group_rows": int(live_tile[probes[gi], ti].sum())}

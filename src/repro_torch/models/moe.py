"""Mixture-of-Experts FFN with sort-based capacity dispatch (the port of
``repro/models/moe.py``).

Top-k route -> stable sort by expert -> position-in-expert via a cumsum ->
a fixed (G, E, C) slot map -> batched expert FFN -> combine, grouped as the
reference groups tokens (``_num_groups``), so that its capacity, and so its
drops, are the reference's. Every shape is static and no step reads a
value back to the host, so a decode step through it captures as one CUDA
graph.

``_dispatch`` and ``_combine`` are the reference's ``shard_map`` bodies.
Over a mesh whose "model" axis shards the experts (the parameters and
buffers DTensors), each rank runs them on its own experts: ``_dispatch``
fills its experts' slots from the batch rows it holds, with no
collective (its slice of the replicated slot maps is local), and
``_combine`` gathers its experts' outputs, masks the (token, k) pairs
routed elsewhere, sums over k and makes one all-reduce over "model" of
the (G, Tg, D) partial in the model dtype, as the reference's ``psum``
does. ``route`` runs on every rank's batch rows alike (replicated over
"model"), its maps the single device's bit for bit for the same gates.
Without such a mesh the single-device path runs. The activations are
pinned with ``launch.sharding.constrain`` at the reference's six sites.
The expert FFN and the router are GEMM glue, plain JAX in the reference
and ``torch.bmm`` / matmul here (DTensor's rules over a mesh). Tie
orders follow the reference: ``jax.lax.top_k`` puts the lowest expert
first among equal gates (a stable descending sort here; ``torch.topk``
promises no order), and ``jnp.argsort`` is stable (``stable=True``). The
slot maps send dropped tokens to a trash row E at slot 0, whose
colliding writes are sliced away, as the reference's are.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.launch import sharding as shd
from repro_torch.launch.sharding import constrain
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import ParamSpec


def moe_specs(cfg: ModelConfig) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    up = ("experts", "embed", "expert_mlp")
    p = {"router": ParamSpec((d, e), ("embed", None), scale=0.1)}
    if cfg.mlp_type == "swiglu":
        p.update({"wi_gate": ParamSpec((e, d, f), up),
                  "wi_up": ParamSpec((e, d, f), up),
                  "wo": ParamSpec((e, f, d), ("experts", "expert_mlp",
                                              "embed"))})
    else:
        p.update({"wi": ParamSpec((e, d, f), up),
                  "wo": ParamSpec((e, f, d), ("experts", "expert_mlp",
                                              "embed"))})
    if cfg.shared_expert:
        p.update({"shared_gate": ParamSpec((d, f), ("embed", "mlp")),
                  "shared_up": ParamSpec((d, f), ("embed", "mlp")),
                  "shared_down": ParamSpec((f, d), ("mlp", "embed"))})
    return p


def _expert_ffn(p, buf: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """buf: (E, G, C, D) -> (E, G, C, D), one batched product an expert's
    weights (the reference's (G, E, C, D) einsums, G x C flattened).

    The activation is taken out of place: over a mesh whose rules shard
    the experts' "embed" (FSDP serving), the first product contracts a
    sharded dimension and is a partial sum, which DTensor reduces before
    the nonlinearity (as XLA does for the reference) and an in-place
    activation cannot take. The gate product is freed as the activation
    is made, so the peak holds two buffers, as the in-place form's."""
    e, g, cap, d = buf.shape
    xb = buf.reshape(e, g * cap, d)
    if cfg.mlp_type == "swiglu":
        h = F.silu(torch.bmm(xb, p.wi_gate))
        h.mul_(torch.bmm(xb, p.wi_up))
    elif cfg.mlp_type == "relu2":
        h = torch.square(F.relu(torch.bmm(xb, p.wi)))
    elif cfg.mlp_type == "gelu":   # jax.nn.gelu's default: the tanh form
        h = F.gelu(torch.bmm(xb, p.wi), approximate="tanh")
    else:
        raise ValueError(cfg.mlp_type)
    h = constrain(h.view(e, g, cap, -1), "experts", "batch", None,
                  "expert_mlp")
    return torch.bmm(h.view(e, g * cap, -1), p.wo).view(e, g, cap, d)


def _num_groups(cfg: ModelConfig, t: int) -> int:
    """Dispatch groups: ``moe_groups`` halved until it divides the token
    count (so t = B·S at prefill and B at decode group differently)."""
    g = cfg.moe_groups
    while g > 1 and t % g != 0:
        g //= 2
    return max(g, 1)


class Route(NamedTuple):
    """A batch's routing, grouped: gates and experts of each (token, k),
    the slot maps of the (G, E, C) buffer and each (token, k)'s slot."""
    gate_k: torch.Tensor        # (G, Tg, k) f32
    idx_k: torch.Tensor         # (G, Tg, k) expert, lowest index first on ties
    tok_for_slot: torch.Tensor  # (G, E, C) int32 token of each slot
    slot_valid: torch.Tensor    # (G, E, C) bool
    es_tok: torch.Tensor        # (G, Tg, k) expert of the slot, E if dropped
    ps_tok: torch.Tensor        # (G, Tg, k) slot in the expert, 0 if dropped
    keep_tok: torch.Tensor      # (G, Tg, k) bool, False where dropped
    aux: torch.Tensor           # () the Switch load-balancing loss


def route(gates_all: torch.Tensor, cfg: ModelConfig) -> Route:
    """Top-k, the aux loss and the capacity dispatch maps from the (G, Tg,
    E) f32 gates (sigmoid or softmax of the router's logits)."""
    g, tg, e = gates_all.shape
    k = cfg.n_experts_active
    dev = gates_all.device
    # jax.lax.top_k: descending, the lowest index first among equal gates
    gate_k, idx_k = torch.sort(gates_all, dim=-1, descending=True,
                               stable=True)
    gate_k, idx_k = gate_k[..., :k], idx_k[..., :k]
    if cfg.router_act != "sigmoid":
        gate_k = gate_k / torch.clamp_min(gate_k.sum(-1, keepdim=True), 1e-9)

    # load-balancing aux loss (Switch): E * sum_e f_e * p_e, group-averaged
    me = gates_all.mean(dim=1)                                   # (G, E)
    ce = torch.zeros((g, e), dtype=torch.float32, device=dev).scatter_add_(
        1, idx_k.reshape(g, -1),
        torch.ones((g, tg * k), dtype=torch.float32, device=dev)) / (tg * k)
    aux = e * torch.mean(torch.sum(me * ce, dim=-1))

    cap = max(1, int(cfg.capacity_factor * tg * k / e))
    flat_e = idx_k.reshape(g, tg * k)
    flat_tok = (torch.arange(tg * k, device=dev) // k).to(torch.int32)[
        None].expand(g, tg * k)
    order = torch.argsort(flat_e, dim=1, stable=True)
    se = torch.gather(flat_e, 1, order)
    stok = torch.gather(flat_tok, 1, order)
    # position in its expert: the count of earlier entries of the same one
    onehot = (se[..., None] == torch.arange(e, device=dev)).to(torch.int32)
    pos = torch.gather(torch.cumsum(onehot, dim=1), 2, se[..., None])[..., 0]
    pos = pos - 1
    keep = pos < cap
    es = torch.where(keep, se, e)                            # E = trash row
    ps = torch.where(keep, pos, 0)

    # slot maps over (E + 1) x C; the trash row's writes collide and go
    slot = es * cap + ps
    tok_for_slot = torch.zeros((g, (e + 1) * cap), dtype=torch.int32,
                               device=dev).scatter_(1, slot, stok)
    slot_valid = torch.zeros((g, (e + 1) * cap), dtype=torch.bool,
                             device=dev).scatter_(1, slot, keep)
    tok_for_slot = tok_for_slot.view(g, e + 1, cap)[:, :e]
    slot_valid = slot_valid.view(g, e + 1, cap)[:, :e]

    # slot coordinates per (token, k) in the original order (invert the sort)
    inv = torch.empty_like(order).scatter_(
        1, order, torch.arange(tg * k, device=dev)[None].expand(g, tg * k))

    def back(x):
        return torch.gather(x, 1, inv).reshape(g, tg, k)

    return Route(gate_k, idx_k, tok_for_slot, slot_valid, back(es), back(ps),
                 back(keep), aux)


def _route_placed(gates_all: torch.Tensor, cfg: ModelConfig) -> Route:
    """``route`` on each rank's groups of a placed (G, Tg, E) gates tensor
    (taken whole over "model"): the maps placed as the gates' groups, the
    aux loss the mean of the ranks' over the groups' mesh axes."""
    from torch.distributed.tensor import Partial
    rows = shd.keep_shard(gates_all.placements, 0)
    aux = tuple(Partial("avg") if p.is_shard(0) else p for p in rows)
    return shd.local_map(lambda gl: route(gl, cfg), (rows,) * 7 + (aux,),
                         (rows,), gates_all)


def _dispatch(xg: torch.Tensor, r: Route) -> torch.Tensor:
    """buf[e, g, c] = xg[g, tok_for_slot[g, e, c]] (masked), laid out
    expert-major so that each expert's slots are one (G·C, D) block.
    Placed: each rank fills its experts' slots (the slot maps sliced on
    their experts, a local slice) from its batch rows; no collective."""
    if not shd.is_placed(xg):
        return dispatch_shard(xg, r.tok_for_slot, r.slot_valid)
    from torch.distributed.tensor import Shard
    g, e, c = r.tok_for_slot.shape
    bp = shd.placements((e, g, c, xg.shape[-1]),
                        ("experts", "batch", None, None))
    rows = shd.keep_shard(xg.placements, 0)
    slots = tuple(Shard(1) if p.is_shard(0) else rows[i]
                  for i, p in enumerate(bp))
    return shd.local_map(dispatch_shard, bp, (rows, slots, slots), xg,
                         r.tok_for_slot, r.slot_valid)


def dispatch_shard(xg, tok_for_slot, slot_valid) -> torch.Tensor:
    """The dispatch of the experts whose (G, E_l, C) slot maps are given
    (all of them on a single device; one shard's slice of the experts
    axis over a mesh): the reference's ``shard_map`` body."""
    g = xg.shape[0]
    gid = torch.arange(g, device=xg.device)[None, :, None]
    buf = xg[gid, tok_for_slot.transpose(0, 1)]              # (E, G, C, D)
    return buf.masked_fill_(~slot_valid.transpose(0, 1)[..., None], 0)


def _combine(yb: torch.Tensor, r: Route, dtype: torch.dtype
             ) -> torch.Tensor:
    """out[g, t] = sum_k gate * yb[e_k, g, c_k] (masked); es is clamped to
    E - 1 before the mask, as the reference clamps it. Placed with the
    experts sharded: each rank clamps the expert ids into its own range,
    masks the pairs routed to other ranks, sums its (G, Tg, D) partial
    over k, and one all-reduce over the experts' mesh axis ("model") sums
    the ranks' partials in ``dtype``."""
    args = (r.es_tok, r.ps_tok, r.keep_tok, r.gate_k)
    if not shd.is_placed(yb):
        return _combine_local(yb, *args, dtype)
    lo, mdim = shd.shard_offset(yb, 0)      # this rank's first expert
    rows = shd.keep_shard(r.es_tok.placements, 0)
    dm = yb.device_mesh

    def body(yl, es, ps, keep, gate):
        if mdim is None:
            return _combine_local(yl, es, ps, keep, gate, dtype)
        return shd.all_reduce(combine_shard(yl, es, ps, keep, gate, lo,
                                            dtype), dm, mdim)

    return shd.local_map(body, rows, (yb.placements,) + (rows,) * 4, yb,
                         *args)


def combine_shard(yb, es_tok, ps_tok, keep_tok, gate_k, lo: int, dtype
                  ) -> torch.Tensor:
    """One expert shard's (G, Tg, D) partial of ``_combine``: ``yb`` holds
    experts [lo, lo + E_l); the expert ids are clamped into that range and
    the (token, k) pairs routed elsewhere masked (the reference's
    ``shard_map`` body before its ``psum``). At lo 0 over every expert it
    is the single device's combine bit for bit."""
    e_l = yb.shape[0]
    mine = keep_tok & (es_tok >= lo) & (es_tok < lo + e_l)
    return _combine_local(yb, (es_tok - lo).clamp(0, e_l - 1), ps_tok, mine,
                          gate_k, dtype)


def _combine_local(yb, es_tok, ps_tok, keep_tok, gate_k, dtype
                   ) -> torch.Tensor:
    """The single device's combine (the reference's ``local_ref``)."""
    e, g = yb.shape[:2]
    ysel = yb[torch.clamp_max(es_tok, e - 1),
              torch.arange(g, device=yb.device)[:, None, None], ps_tok]
    ysel.mul_(gate_k.to(dtype)[..., None])
    ysel.masked_fill_(~keep_tok[..., None], 0)
    return ysel.sum(dim=2)                                   # (G, Tg, D)


def moe_ffn(p, x: torch.Tensor, cfg: ModelConfig
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out (B, S, D), aux_loss scalar)."""
    b, s, d = x.shape
    t = b * s
    g = _num_groups(cfg, t)
    tg = t // g
    xg = constrain(x.reshape(g, tg, d), "batch", None, None)

    # the router's logits pinned to the groups' placement: over a mesh
    # whose rules shard the router's embed dim (FSDP serving), DTensor may
    # otherwise leave the groups sharded over "model" too, where each rank
    # routes its own batch rows whole
    logits = constrain((xg @ p.router).float(), "batch", None, None)
    if cfg.router_act == "sigmoid":                          # llama4-style
        gates_all = torch.sigmoid(logits)
    else:
        gates_all = torch.softmax(logits, dim=-1)
    r = (_route_placed if shd.is_placed(gates_all) else route)(gates_all,
                                                                  cfg)

    # the buffers are expert-major, (E, G, C, D): their logical axes in
    # that order
    buf = constrain(_dispatch(xg, r), "experts", "batch", None, None)
    yb = constrain(_expert_ffn(p, buf, cfg), "experts", "batch", None, None)
    del buf
    out = _combine(yb, r, x.dtype)                           # (G, Tg, D)

    if cfg.shared_expert:
        h = F.silu(xg @ p.shared_gate) * (xg @ p.shared_up)
        h = constrain(h, "batch", None, "mlp")
        out = out + h @ p.shared_down
    return constrain(out.reshape(b, s, d), "batch", "seq", "embed"), r.aux

"""Dry-run of every (arch x shape) cell on one H100, counted on the meta
device, and of every (arch x shape x mesh) cell on the reference's
production meshes, sized per device (the port of
``repro/launch/dryrun.py``).

    python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape train_4k
    python -m repro_torch.launch.dryrun --all [--kv pq] [--out build/dryrun]
    python -m repro_torch.launch.dryrun --all --mesh both

The reference lowers and compiles each cell's step for a TPU pod on 512
placeholder CPU devices. Here each cell's step runs on the **meta
device** by design: its parameters, optimizer state, caches and batch are
meta tensors (shapes and dtypes, no data), so the step allocates nothing
and never touches a card, even where one is present. This is not a CPU
fallback: nothing is computed. ``launch/cost_analysis.py`` counts the
aten ops the step runs (FLOPs, bytes, launches, live storages), K8
records its own cost through its meta branch, and ``launch/roofline.py``
turns the counts into a roofline of one card. Each cell writes one JSON.

A cell sized for the reference's 256 chips may not fit one 80 GB card
(qwen3-1.7b's decode_32k exact cache alone is ~481 GB): it is still
``status: "ok"``, with ``fits: false`` and ``cards_by_memory``, the
cards its peak of live bytes would fill.

``--mesh pod | multipod | both`` runs a cell on the reference's (16, 16)
or (2, 16, 16) mesh (``launch/mesh.py``) under the reference's rules
(``cell_rules``). Every cell gets ``per_device``: its meta parameters,
optimizer state, caches and batch, each mapped with its logical axes
through ``sharding.tree_shardings``, give the bytes of one device's
shards, the leaves placed whole on every device, the rules that depart
from ``DEFAULT_RULES``, and whether the static bytes fit one card. A
prefill or decode cell of any family is also counted per
device (``count_mesh_cell``): a fake process group of the mesh's ranks
(rank 0's view; nothing is sent) holds a ``DeviceMesh`` of the
production shape, ``mesh_cell`` places the meta tensors on it as
DTensors and runs the step, and ``cost_analysis`` counts the local ops
and the collectives: ``flops``, ``op_bytes``, ``min_bytes``,
``peak_live_bytes`` and ``launches`` of one device, ``collectives``
(``ops``, ``bytes_by_op``, ``wire_bytes_per_dev``) and a ``roofline`` of
``mesh.size`` chips. Training cells are not run over ranks yet: their
``roofline`` is null (``COUNTED_ON_A_MESH``).

``mesh_cell`` is the counterpart of the reference's ``build_cell`` with
its ``in_shardings`` for the serving cells: it
places the parameters, the cache and the batch as DTensors over a
``DeviceMesh`` of the process group's ranks by ``cell_rules`` and runs
the prefill or decode step over them (gloo ranks on the CPU, NCCL, or
the fake group of ``count_mesh_cell``).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import sys
import time
import traceback
from typing import Callable, NamedTuple

import torch

from repro_torch import configs
from repro_torch.data import tokens as tok
from repro_torch.launch import cost_analysis as ca
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import roofline as rl
from repro_torch.launch import sharding as shd
from repro_torch.models import layers as ll
from repro_torch.models import model as model_lib
from repro_torch.models.config import ModelConfig
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import train_loop

MESH = "h100x1"
# the reference's production meshes, sized per device
POD_MESHES = ("pod", "multipod")
META = torch.device("meta")
# what a pod cell that runs no step over ranks is counted by
COUNTED_ON_A_MESH = ("bytes per device under the rules; the step is not run "
                     "over ranks yet, so per-device FLOPs and collective "
                     "bytes wait for training over a mesh (ROADMAP, Queue "
                     "1, item 6)")
# what a pod cell that runs its step over ranks is counted by
COUNTED_PER_DEVICE = ("the step over DTensors on a fake group of the mesh's "
                      "ranks, counted at rank 0 (count_mesh_cell)")

# (seq_len, global_batch, kind)
SHAPES = {
    "train_4k": (4096, 256, "train"),
    "prefill_32k": (32768, 32, "prefill"),
    "decode_32k": (32768, 128, "decode"),
    "long_500k": (524288, 1, "decode"),
}

SUBQUADRATIC = ("mamba2", "rwkv6")  # block types allowed to run long_500k


def cell_supported(cfg: ModelConfig, shape: str) -> tuple[bool, str]:
    if shape == "long_500k" and cfg.block_type not in SUBQUADRATIC:
        return False, ("SKIP: long_500k needs sub-quadratic attention; "
                       f"{cfg.name} is pure full-attention (see DESIGN.md)")
    return True, ""


def batch_specs(cfg: ModelConfig, batch: int, seq: int) -> dict:
    """Meta stand-ins of a training batch (with the frontend stub's
    embeddings for the frontend archs)."""
    specs = tok.input_specs_lm(cfg.vocab, seq, batch)
    if cfg.frontend != "none":
        specs["frontend_embeds"] = torch.empty(
            (batch, cfg.frontend_len, cfg.d_model),
            dtype=model_lib.model_dtype(cfg), device=META)
    return specs


def batch_axes(cfg: ModelConfig) -> dict:
    """The logical axes of ``batch_specs``'s tensors."""
    axes = {"tokens": ("batch", "seq"), "targets": ("batch", "seq"),
            "mask": ("batch", "seq")}
    if cfg.frontend != "none":
        axes["frontend_embeds"] = ("batch", None, "embed")
    return axes


def serving_rules(cfg: ModelConfig, mesh: mesh_lib.Mesh) -> dict:
    """Serving shards params TP-only (replicated over data) when they fit:
    FSDP-style weight all-gathers are amortized over 1M tokens in training
    but dominate a single decode step. Falls back to FSDP sharding when
    bf16 params / model-axis exceed the HBM budget (dbrx-132b).

    Archs whose head count does not divide the model axis (qwen1.5: 40H,
    llama4: 40H, internvl2: 14H) would otherwise replicate ALL attention
    weight+compute; for those we shard head_dim instead, and shard the
    PQ-KV codes across sub-quantizers ("pq_m") — sub-space parallelism for
    the paper's ADC: each chip scans its own nibble planes and one small
    int32 partial-accumulation all-reduce merges them."""
    rules = dict(shd.DEFAULT_RULES)
    param_bytes = cfg.param_count() * 2  # bf16
    model_size = mesh.shape.get("model", 1)
    if param_bytes / model_size <= 12e9:
        rules["embed"] = None
    if cfg.n_heads and cfg.n_heads % model_size != 0:
        rules["head_dim"] = "model"
        if cfg.kv_pq:
            rules["pq_m"] = "model"
            rules["kv_seq"] = None
    return rules


def cell_rules(cfg: ModelConfig, shape_name: str, mesh: mesh_lib.Mesh
               ) -> dict:
    kind = SHAPES[shape_name][2]
    return (dict(shd.DEFAULT_RULES) if kind == "train"
            else serving_rules(cfg, mesh))


def mesh_trees(cfg: ModelConfig, kind: str, batch: int, seq: int) -> dict:
    """The cell's tensors on the meta device beside their logical axes, by
    role, as the reference's ``build_cell`` shards them: the parameters;
    training: the optimizer state and the batch; prefill: the prompt
    (and with ``cfg.kv_pq`` the cache its codes fill); decode: the cache,
    the tokens and the positions."""
    params = model_lib.lm_shapes(cfg)
    paxes = model_lib.lm_axes(cfg)
    trees = {"param": (params, paxes)}
    if kind == "train":
        trees["opt"] = (opt_lib.state_shapes(params),
                        opt_lib.state_axes(paxes))
        trees["batch"] = (batch_specs(cfg, batch, seq), batch_axes(cfg))
        return trees
    if kind == "decode" or cfg.kv_pq:
        trees["cache"] = (model_lib.init_cache(cfg, batch, seq, device=META),
                          model_lib.cache_axes(cfg))
    if kind == "prefill":
        trees["batch"] = (
            {"tokens": torch.empty((batch, seq), dtype=torch.int32,
                                   device=META)},
            {"tokens": ("batch", "seq")})
    else:
        trees["batch"] = (
            {n: torch.empty((batch,), dtype=torch.int32, device=META)
             for n in ("tokens", "position")},
            {"tokens": ("batch",), "position": ("batch",)})
    return trees


def per_device(cfg: ModelConfig, kind: str, batch: int, seq: int,
               mesh: mesh_lib.Mesh, rules: dict) -> dict:
    """One device's bytes of each role under ``rules`` on ``mesh``
    (``param_bytes``, ``opt_bytes``, ``cache_bytes``, ``batch_bytes``;
    ``static_bytes`` the first three), the leaves no mesh axis shards
    (``replicated_leaves``, ``replicated_bytes``, parameters and state
    alike), the rules that depart from ``DEFAULT_RULES``, and whether the
    static bytes fit one card."""
    out = {f"{role}_bytes": 0 for role in ("param", "opt", "cache", "batch")}
    whole, whole_bytes = 0, 0
    for role, (tensors, axes) in mesh_trees(cfg, kind, batch, seq).items():
        shardings = shd.tree_shardings(tensors, axes, mesh, rules)
        for _, t, sh in shd.sharded_leaves(tensors, shardings):
            nbytes = math.prod(sh.shard_shape(t.shape)) * t.element_size()
            out[f"{role}_bytes"] += nbytes
            if all(e is None for e in sh.spec):
                whole += 1
                whole_bytes += nbytes
    out["static_bytes"] = (out["param_bytes"] + out["opt_bytes"]
                           + out["cache_bytes"])
    out.update(replicated_leaves=whole, replicated_bytes=whole_bytes,
               rules={k: v for k, v in rules.items()
                      if shd.DEFAULT_RULES.get(k) != v},
               fits=out["static_bytes"] <= rl.HBM_BYTES)
    return out


class Cell(NamedTuple):
    """A step ready to count: ``fn()`` runs it; ``live`` holds what is
    alive when it starts; ``static`` the parameters, optimizer state and
    caches among them; ``compulsory(result)`` the step's compulsory bytes
    given what it returned; ``live_positions`` a decode step's."""
    fn: Callable[[], object]
    live: tuple
    static: tuple
    compulsory: Callable[[object], int]
    live_positions: int | None


# cache entries by their role: rows along a sequence axis (axis 2), read
# only (codebooks), or states read and written whole
_SEQ = ("k", "v", "k_codes", "v_codes", "attn_k", "attn_v", "attn_k_codes",
        "attn_v_codes")
_READ = ("k_cb", "v_cb", "attn_k_cb", "attn_v_cb")


def cache_entries(cache) -> dict:
    """A cache's tensors by name (a ``NamedTuple``'s fields, a dict's
    keys)."""
    return cache._asdict() if hasattr(cache, "_asdict") else dict(cache)


def decode_cache_bytes(cache, live: int) -> int:
    """A decode step's compulsory cache traffic: each sequence store's
    ``live`` rows read and the new row written, each codebook read, each
    recurrent state read and written."""
    total = 0
    for name, t in cache_entries(cache).items():
        nbytes = t.numel() * t.element_size()
        if name in _SEQ:
            row = nbytes // t.shape[2]
            total += row * (min(live, t.shape[2]) + 1)
        elif name in _READ:
            total += nbytes
        else:
            total += 2 * nbytes
    return total


def build_cell(cfg: ModelConfig, kind: str, batch: int, seq: int, *,
               live: int | None = None, microbatches: int = 1) -> Cell:
    """The cell's step on meta tensors. ``train``: ``loss_fn``, its
    backward and ``apply_updates`` through ``make_train_step`` (trainable
    parameters, f32 moments, ``microbatches`` as the loop takes them);
    ``prefill``: exact, or PQ into a cache with meta codebooks;
    ``decode``: one token against a ``seq``-position cache
    (``init_cache``) whose first ``live`` positions (default all) are
    live."""
    params = model_lib.lm_shapes(cfg)
    pbytes = ca.tree_bytes(params)
    if kind == "train":
        ll.set_trainable(params)
        opt = opt_lib.state_shapes(params)
        state = train_loop.TrainState(params, opt, None)
        data = batch_specs(cfg, batch, seq)
        step = train_loop.make_train_step(
            cfg, opt_lib.AdamWConfig(total_steps=1000), microbatches)
        obytes = ca.tree_bytes(opt)
        # every parameter and moment read and written once, the batch read
        need = 2 * pbytes + 2 * obytes + ca.tree_bytes(data)
        return Cell(lambda: step(state, data), (params, opt, data),
                    (params, opt), lambda _: need, None)

    if kind == "prefill":
        tokens = torch.empty((batch, seq), dtype=torch.int32, device=META)
        pq = None
        if cfg.kv_pq and (cfg.block_type == "attn" or cfg.shared_attn_every):
            pq = model_lib.init_cache(cfg, batch, seq, device=META)

        def compulsory(result):
            # the parameters and prompt read, the logits and cache written
            # (a PQ cache's codebooks read)
            return pbytes + ca.tree_bytes(tokens) + ca.tree_bytes(result)

        return Cell(lambda: model_lib.prefill(params, tokens, cfg,
                                              max_seq=seq, pq_cache=pq),
                    (params, tokens, pq), (params, pq), compulsory, None)

    live = seq if live is None else live
    cache = model_lib.init_cache(cfg, batch, seq, device=META)
    tokens = torch.empty((batch,), dtype=torch.int32, device=META)
    position = torch.empty((batch,), dtype=torch.int32, device=META)
    need = (pbytes + decode_cache_bytes(cache, live)
            + ca.tree_bytes(tokens, position))

    def compulsory(result):
        return need + result[0].numel() * result[0].element_size()

    return Cell(lambda: model_lib.decode_step(params, cache, tokens,
                                              position, cfg),
                (params, cache, tokens, position), (params, cache),
                compulsory, live)


def count_cell(cfg: ModelConfig, kind: str, batch: int, seq: int,
               **kw) -> ca.Costs:
    """``build_cell``'s step counted: the op costs, the compulsory bytes
    and the static bytes (parameters, optimizer state, caches)."""
    cell = build_cell(cfg, kind, batch, seq, **kw)
    result, costs = ca.count(cell.fn, live=cell.live,
                             live_positions=cell.live_positions)
    costs.min_bytes = cell.compulsory(result)
    costs.static_bytes = ca.tree_bytes(*cell.static)
    return costs


def roofline(cfg: ModelConfig, arch: str, shape: str, kind: str, batch: int,
             seq: int, costs: ca.Costs, mesh: str = MESH, chips: int = 1
             ) -> rl.Roofline:
    """A device's roofline of counted ``costs`` over ``chips`` devices:
    the counted FLOPs, the compulsory bytes and the wire bytes of one
    device (none on one card)."""
    return rl.Roofline(
        arch=arch, shape=shape, mesh=mesh, chips=chips,
        hlo_flops_per_dev=costs.flops, hlo_bytes_per_dev=costs.min_bytes,
        wire_bytes_per_dev=costs.wire_bytes,
        model_flops_total=rl.model_flops(cfg, kind, batch, seq),
        collectives=dict(costs.collective_ops))


class MeshCell(NamedTuple):
    """A prefill or decode cell over a mesh of ranks (``mesh_cell``):
    ``step(tokens=None, position=None)`` places full tokens (and
    positions) and runs the step under the mesh, returning its (logits,
    cache), both placed; the cell's own inputs when called without
    them. ``params`` and ``cache`` are the placed parameters and cache
    (a decode step writes the cache in place)."""
    step: Callable
    params: object
    cache: object


def mesh_cell(cfg: ModelConfig, kind: str, mesh: mesh_lib.Mesh, rules: dict,
              params, *, tokens: torch.Tensor, cache=None,
              position: torch.Tensor | None = None,
              max_seq: int | None = None,
              frontend_embeds: torch.Tensor | None = None) -> MeshCell:
    """The counterpart of the reference's ``build_cell`` with its
    ``in_shardings``, run over ``mesh`` (its ``DeviceMesh`` over the
    process group's ranks): the parameters, the cache (exact, or PQ with
    its codebooks) and the tokens placed as DTensors by ``rules`` (the
    reference's ``cell_rules``) through ``sharding.shard_tree``, each
    full tensor the same on every rank. ``kind`` "prefill": ``tokens``
    (B, S), the exact cache of ``max_seq`` positions made placed (or the
    PQ ``cache``'s codes filled in place); "decode": ``tokens`` and
    ``position`` (B,) against ``cache`` (full tensors, or a prefill cell's
    placed cache). Decode runs eagerly (no graph over collectives). A PQ
    cache sharded on "kv_seq" runs K8's sharded mode, one sharded on
    "pq_m" (the rules' branch for heads that do not divide the model
    axis) its sub-space mode.

    The recurrent families run their scans and state updates on each
    rank's heads (``ssm_heads``); the hybrid's shared attention as the
    attention family's. Training over several ranks raises
    (``sharding.NEXT_SLICE``)."""
    if kind == "train":
        raise NotImplementedError(
            f"mesh_cell: {cfg.name} {kind} over ranks; {shd.NEXT_SLICE}")
    if kind not in ("prefill", "decode"):
        raise ValueError(f"kind {kind!r}: want prefill or decode")
    if mesh.device_mesh is None:
        raise ValueError(f"mesh_cell: {mesh} has no DeviceMesh")
    if kind == "decode" and (cache is None or position is None):
        raise ValueError("a decode cell needs a cache and positions")
    if kind == "prefill" and cfg.kv_pq and cache is None:
        raise ValueError("a PQ prefill cell needs a cache with codebooks")
    # placed as inference tensors, as the steps' own are (a DTensor view
    # of a tensor made outside inference mode fails inside it)
    with torch.inference_mode():
        pp = shd.shard_tree(params, model_lib.lm_axes(cfg), mesh, rules)
        pc = None if cache is None else shd.shard_tree(
            cache, model_lib.cache_axes(cfg), mesh, rules)
    baxes = serving_batch_axes(cfg, kind)

    @torch.inference_mode()
    def step(tokens=tokens, position=position):
        batch = {"tokens": tokens}
        if kind == "decode":
            batch["position"] = position
        if frontend_embeds is not None:
            batch["frontend_embeds"] = frontend_embeds
        placed = shd.shard_tree(batch, {k: baxes[k] for k in batch}, mesh,
                                rules)
        with shd.use_mesh(mesh, rules):
            if kind == "prefill":
                return model_lib.prefill(
                    pp, placed["tokens"], cfg, max_seq=max_seq, pq_cache=pc,
                    frontend_embeds=placed.get("frontend_embeds"))
            return model_lib.decode_step(pp, pc, placed["tokens"],
                                         placed["position"], cfg)

    return MeshCell(step, pp, pc)


def serving_batch_axes(cfg: ModelConfig, kind: str) -> dict:
    """The logical axes of a serving cell's batch tensors: the prompt (and
    the frontend stub's embeddings), or a decode step's tokens and
    positions."""
    if kind == "prefill":
        axes = {"tokens": ("batch", "seq")}
        if cfg.frontend != "none":
            axes["frontend_embeds"] = ("batch", None, "embed")
        return axes
    return {"tokens": ("batch",), "position": ("batch",)}


def runs_over_ranks(kind: str) -> bool:
    """Whether ``mesh_cell`` runs a cell of ``kind`` over ranks (the
    serving cells, of every family)."""
    return kind in ("prefill", "decode")


@contextlib.contextmanager
def fake_group(mesh: mesh_lib.Mesh):
    """``mesh`` with a ``DeviceMesh`` over a fake process group of its
    ranks, this process rank 0 (torch's ``fake`` backend: collectives
    return at once and send nothing), typed as a mesh of CUDA cards; the
    group is destroyed on exit. A process group initialized already is
    refused."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is initialized already: the "
                           "count over a fake group of the mesh's ranks "
                           "would replace it")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=mesh.size)
    try:
        dm = init_device_mesh("cpu", tuple(mesh.shape.values()),
                              mesh_dim_names=tuple(mesh.shape))
        # typed as the card's mesh, so that DTensor moves a shard from one
        # dim to another with NCCL's all-to-all, not with the all-gather
        # and chunk it takes over gloo (which has none); the fake backend
        # serves both types, and the tensors are meta tensors
        if isinstance(getattr(type(dm), "device_type", None), property):
            dm._device_type = "cuda"
        else:
            dm.device_type = "cuda"
        yield mesh_lib.Mesh(mesh.shape, dm)
    finally:
        dist.destroy_process_group()


def count_mesh_cell(cfg: ModelConfig, kind: str, batch: int, seq: int,
                    mesh: mesh_lib.Mesh, rules: dict) -> ca.Costs:
    """One device's counts of a prefill or decode cell over ``mesh``: the
    meta trees (``mesh_trees``) placed by ``rules`` through ``mesh_cell``
    and its step counted under ``CostCounter`` (the local ops, the
    collectives). ``mesh`` a description: over a fake group of its ranks
    (``fake_group``, rank 0); a mesh with a ``DeviceMesh``: over that
    group's. ``min_bytes`` is ``build_cell``'s compulsory rule on each
    leaf's local shard: the local parameters, the live rows of the local
    cache read and the new row written (a decode step; every position
    live), the local inputs and outputs."""
    if not runs_over_ranks(kind):
        raise NotImplementedError(
            f"count_mesh_cell: {cfg.name} {kind} over ranks; "
            f"{shd.NEXT_SLICE}")
    if mesh.device_mesh is None:
        with fake_group(mesh) as placed:
            return count_mesh_cell(cfg, kind, batch, seq, placed, rules)
    trees = mesh_trees(cfg, kind, batch, seq)
    cache = trees["cache"][0] if "cache" in trees else None
    inputs = trees["batch"][0]
    cell = mesh_cell(cfg, kind, mesh, rules, trees["param"][0],
                     tokens=inputs["tokens"], cache=cache,
                     position=inputs.get("position"), max_seq=seq)
    # the batch placed before the count, as the one-card count's inputs
    # are made before it
    with torch.inference_mode():
        axes = serving_batch_axes(cfg, kind)
        placed = shd.shard_tree(inputs, {k: axes[k] for k in inputs}, mesh,
                                rules)
    live = seq if kind == "decode" else None
    result, costs = ca.count(cell.step, live=(cell.params, cell.cache, placed),
                             live_positions=live, **placed)
    pbytes = ca.tree_bytes(cell.params)
    if kind == "prefill":
        # the parameters and prompt read, the logits and cache written
        costs.min_bytes = pbytes + ca.tree_bytes(placed) + ca.tree_bytes(
            result)
    else:
        local = {k: ca._local(t)
                 for k, t in cache_entries(cell.cache).items()}
        costs.min_bytes = (pbytes + decode_cache_bytes(local, seq)
                           + ca.tree_bytes(placed) + ca.tree_bytes(result[0]))
    costs.static_bytes = ca.tree_bytes(cell.params, cell.cache)
    return costs


def size_pod_cell(cfg: ModelConfig, shape_name: str, mesh: str
                  ) -> tuple[mesh_lib.Mesh, dict, dict]:
    """A cell on the ``pod`` or ``multipod`` mesh sized per device: the
    production mesh, the cell's rules on it, and the fields of its result
    before any count (``status``, ``chips``, ``per_device``; ``counted``
    and ``roofline`` as a cell that runs no step over ranks has them)."""
    seq, batch, kind = SHAPES[shape_name]
    m = mesh_lib.make_production_mesh(multi_pod=mesh == "multipod")
    rules = cell_rules(cfg, shape_name, m)
    return m, rules, dict(status="ok", chips=m.size,
                          per_device=per_device(cfg, kind, batch, seq, m,
                                                rules),
                          counted=COUNTED_ON_A_MESH, roofline=None)


def run_cell(arch: str, shape_name: str, *, mesh: str = MESH,
             kv_override: str = "auto", out_dir: str | None = None,
             verbose: bool = True) -> dict:
    """One cell: on ``h100x1`` counted on the meta device as one card;
    on ``pod`` or ``multipod`` sized per device (``size_pod_cell``) and,
    where ``mesh_cell`` runs it, counted per device (``count_mesh_cell``;
    a prefill_32k cell takes about a minute of one core)."""
    if mesh != MESH and mesh not in POD_MESHES:
        raise ValueError(f"mesh {mesh!r}: not one of {(MESH,) + POD_MESHES}")
    cfg = configs.get_config(arch)
    if kv_override == "exact":
        cfg = cfg.replace(kv_pq=False)
    elif kv_override == "pq":
        cfg = cfg.replace(kv_pq=True)
    seq, batch, kind = SHAPES[shape_name]
    ok, why = cell_supported(cfg, shape_name)
    result = {"arch": arch, "shape": shape_name, "mesh": mesh,
              "kind": kind, "seq": seq, "batch": batch,
              "kv_override": None if kv_override == "auto" else kv_override,
              "kv_pq": cfg.kv_pq and kind in ("decode", "prefill"),
              "params": cfg.param_count(),
              "active_params": cfg.active_param_count()}
    if not ok:
        result["status"] = "skipped"
        result["reason"] = why
        if verbose:
            print(f"[dryrun] {arch} x {shape_name} x {mesh}: {why}")
    elif mesh in POD_MESHES:
        m, rules, sized = size_pod_cell(cfg, shape_name, mesh)
        result.update(sized)
        pd = sized["per_device"]
        note = ""
        if runs_over_ranks(kind):
            t0 = time.perf_counter()
            costs = count_mesh_cell(cfg, kind, batch, seq, m, rules)
            roof = roofline(cfg, arch, shape_name, kind, batch, seq, costs,
                            mesh, m.size)
            result.update(
                counted=COUNTED_PER_DEVICE,
                trace_s=round(time.perf_counter() - t0, 2),
                **costs.to_dict(),
                matmul_flops=costs.matmul_flops,
                matmul_by_op={k: v for k, v in costs.flops_by_op.items()
                              if k in ca.MATMUL_OPS},
                collectives=costs.collectives(), roofline=roof.to_dict())
            note = (f"; {costs.flops:.3e} FLOPs, "
                    f"{costs.wire_bytes / 1e9:.2f} GB on the wire a device, "
                    f"bottleneck={roof.bottleneck}, "
                    f"t_bound={roof.t_bound * 1e3:.2f}ms, "
                    f"mfu_bound={roof.mfu_bound:.3f}")
        if verbose:
            print(f"[dryrun] {arch} x {shape_name} x {mesh}: OK (per device"
                  f" of {m.size}: params {pd['param_bytes'] / 1e9:.2f} GB, "
                  f"opt {pd['opt_bytes'] / 1e9:.2f} GB, cache "
                  f"{pd['cache_bytes'] / 1e9:.2f} GB, replicated "
                  f"{pd['replicated_bytes'] / 1e9:.2f} GB, fits="
                  f"{pd['fits']}; rules {pd['rules']}{note})")
    else:
        t0 = time.perf_counter()
        costs = count_cell(cfg, kind, batch, seq)
        roof = roofline(cfg, arch, shape_name, kind, batch, seq, costs)
        peak = costs.peak_live_bytes
        result.update(
            status="ok", trace_s=round(time.perf_counter() - t0, 2),
            **costs.to_dict(), fits=peak <= rl.HBM_BYTES,
            cards_by_memory=math.ceil(peak / rl.HBM_BYTES),
            roofline=roof.to_dict())
        if verbose:
            print(f"[dryrun] {arch} x {shape_name} x {MESH}: OK (trace "
                  f"{result['trace_s']:.1f}s, {costs.launches} ops, "
                  f"bottleneck={roof.bottleneck}, "
                  f"t_bound={roof.t_bound * 1e3:.2f}ms, "
                  f"mfu_bound={roof.mfu_bound:.3f}, peak "
                  f"{peak / 1e9:.1f} GB, fits={result['fits']})")
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        suffix = "" if kv_override == "auto" else f"_{kv_override}"
        path = os.path.join(out_dir, f"{arch}_{shape_name}_{mesh}{suffix}.json")
        with open(path, "w") as f:
            json.dump(result, f, indent=1)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--mesh", default=MESH,
                    choices=[MESH, *POD_MESHES, "both"],
                    help="one H100 counted on the meta device (default), or "
                    "the reference's pod / multipod mesh sized per device "
                    "(both: the two)")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--kv", default="auto", choices=["auto", "exact", "pq"])
    ap.add_argument("--out", default="build/dryrun")
    args = ap.parse_args(argv)

    archs = (list(configs.ALIASES) if (args.all or not args.arch)
             else [args.arch])
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = list(POD_MESHES) if args.mesh == "both" else [args.mesh]
    failures = []
    for arch in archs:
        for shape in shapes:
            for mesh in meshes:
                try:
                    r = run_cell(arch, shape, mesh=mesh, out_dir=args.out,
                                 kv_override=args.kv)
                    if r["status"] not in ("ok", "skipped"):
                        failures.append((arch, shape, mesh))
                except Exception as e:
                    traceback.print_exc()
                    failures.append((arch, shape, mesh, str(e)[:200]))
    if failures:
        print(f"[dryrun] FAILURES: {failures}")
        return 1
    print("[dryrun] all requested cells passed")
    return 0


if __name__ == "__main__":
    sys.exit(main())

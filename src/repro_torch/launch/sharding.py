"""Logical-axis sharding: partition rules, the divisibility fallback, the
mesh context (the port of ``repro/launch/sharding.py``).

Model code names each tensor dimension by a *logical* axis ("batch",
"embed", "heads", ...). A rules table maps logical names to mesh axes.
The mapping is applied
  - to parameters, optimizer state, caches and batches through their axes
    trees (``tree_shardings``), and
  - to activations by ``constrain(x, ...)``, a no-op without a mesh.

Divisibility fallback: where a dimension does not divide the product of
its mesh axes (14 heads on a 16-wide model axis), the mapping drops mesh
axes from its end until it divides, and replicates the dimension when
none is left, so one rules table serves all ten architectures. A mesh
axis shards at most one dimension of a tensor.

A spec is a tuple with one entry a dimension: None (replicated), a mesh
axis name, or a tuple of two or more names (the dimension split over
them, the first the major), as the reference's ``PartitionSpec`` entries
are. ``NamedSharding.placements()`` gives a spec as DTensor placements.
"""
from __future__ import annotations

import contextlib
import math
import threading
from dataclasses import dataclass
from typing import Any, Mapping, Sequence

from repro_torch.launch.mesh import Mesh

# Logical axis -> mesh axis (or tuple of mesh axes, or None = replicate).
# "fsdp" style weight sharding rides the data axis; TP rides "model".
DEFAULT_RULES: dict[str, Any] = {
    "batch": ("pod", "data"),       # data parallel over pod+data
    # NOTE: "seq" defaults to replicated. A Megatron-SP-style "seq": "model"
    # was the v0 default; the dry-run roofline showed it reshards the
    # residual stream inside the layer/chunk loops (1600+ all-to-alls/step,
    # 370 GB/device wire on qwen3 train_4k) — group remat is the cheaper fix
    # for activation memory.
    "seq": None,
    # FSDP/ZeRO-3 via one rule: weight matrices shard their "embed" dim over
    # the data axis (activations keep embed replicated because their "batch"
    # dim consumes the data axis first — logical_to_spec never reuses axes).
    # Gradients then reduce-scatter instead of all-reduce, and optimizer
    # state is sharded 256-way. Without this, qwen1.5-32b+ cannot fit
    # params+moments on a 16 GB v5e.
    "embed": "data",
    "heads": "model",               # TP over attention heads
    "kv_heads": "model",
    "head_dim": None,
    "mlp": "model",                 # TP over FFN hidden
    "vocab": "model",               # TP over vocab (embedding + logits)
    "experts": "model",             # EP over experts
    "expert_mlp": None,
    "fsdp": "data",                 # parameter sharding over the data axis
    "ssm_heads": "model",           # TP over SSM heads
    "ssm_state": None,
    "conv": None,
    "lora": None,
    "kv_seq": "model",              # decode KV cache: shard context over model
    "stack": None,                  # scan-over-layers leading axis
    "pq_m": None,
    None: None,
}

# what is not placed over several ranks yet, named where it raises
NEXT_SLICE = "ROADMAP.md, Queue 1: training over several ranks (item 6)"

_ctx = threading.local()


def _get_ctx() -> tuple[Mesh | None, Mapping[str, Any] | None]:
    return getattr(_ctx, "mesh", None), getattr(_ctx, "rules", None)


@contextlib.contextmanager
def use_mesh(mesh: Mesh, rules: Mapping[str, Any] | None = None):
    """Activate a mesh and rules for ``constrain`` in this thread; the
    previous ones come back on exit."""
    old = _get_ctx()
    _ctx.mesh, _ctx.rules = mesh, dict(rules or DEFAULT_RULES)
    try:
        yield
    finally:
        _ctx.mesh, _ctx.rules = old


def _axis_size(mesh: Mesh, mesh_axes) -> int:
    if mesh_axes is None:
        return 1
    if isinstance(mesh_axes, str):
        mesh_axes = (mesh_axes,)
    return math.prod(mesh.shape.get(a, 1) for a in mesh_axes)


def _resolve_axis(mesh: Mesh, rules: Mapping[str, Any], logical: str | None):
    """Logical name -> mesh axes entry, dropping axes missing from the mesh."""
    entry = rules.get(logical, None)
    if entry is None:
        return None
    axes = (entry,) if isinstance(entry, str) else tuple(entry)
    axes = tuple(a for a in axes if a in mesh.shape)
    if not axes:
        return None
    return axes if len(axes) > 1 else axes[0]


def logical_to_spec(shape: Sequence[int], logical_axes: Sequence[str | None],
                    mesh: Mesh, rules: Mapping[str, Any]) -> tuple:
    """A spec with the divisibility fallback a dimension."""
    if len(shape) != len(logical_axes):
        raise ValueError(f"shape {tuple(shape)} has no {len(shape)} axes in "
                         f"{tuple(logical_axes)}")
    used: set[str] = set()
    out = []
    for dim, name in zip(shape, logical_axes):
        entry = _resolve_axis(mesh, rules, name)
        if entry is None:
            out.append(None)
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        axes = tuple(a for a in axes if a not in used)
        size = _axis_size(mesh, axes)
        if size <= 1 or dim % size != 0:
            # drop axes from the end of the tuple before giving up entirely
            while axes and (dim % _axis_size(mesh, axes) != 0):
                axes = axes[:-1]
            if not axes:
                out.append(None)
                continue
        used.update(axes)
        out.append(axes if len(axes) > 1 else axes[0])
    return tuple(out)


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh."""
    mesh: Mesh
    spec: tuple

    def _entry(self, d: int):
        return self.spec[d] if d < len(self.spec) else None

    def shard_shape(self, shape: Sequence[int]) -> tuple[int, ...]:
        """The shape of one device's shard of a ``shape`` tensor."""
        out = []
        for d, dim in enumerate(shape):
            n = _axis_size(self.mesh, self._entry(d))
            if dim % n:
                raise ValueError(f"dim {d} of {tuple(shape)} does not divide "
                                 f"into {n} shards ({self.spec})")
            out.append(dim // n)
        return tuple(out)

    def placements(self) -> tuple:
        """The DTensor placements, one a mesh dimension in mesh order:
        ``Shard(d)`` where that mesh axis shards tensor dim ``d``, else
        ``Replicate()``. A dimension split over several mesh axes keeps
        the spec's major-to-minor order only where its tuple follows the
        mesh's order; any other order is refused."""
        from torch.distributed.tensor import Replicate, Shard
        names = list(self.mesh.shape)
        out = [Replicate()] * len(names)
        for d, entry in enumerate(self.spec):
            if entry is None:
                continue
            axes = (entry,) if isinstance(entry, str) else entry
            idx = [names.index(a) for a in axes]
            if idx != sorted(idx):
                raise ValueError(f"spec entry {entry} of dim {d} does not "
                                 f"follow the mesh's order {tuple(names)}")
            for i in idx:
                out[i] = Shard(d)
        return tuple(out)


def named_sharding(shape: Sequence[int], logical_axes: Sequence[str | None],
                   mesh: Mesh, rules: Mapping[str, Any] | None = None
                   ) -> NamedSharding:
    return NamedSharding(mesh, logical_to_spec(shape, logical_axes, mesh,
                                               rules or DEFAULT_RULES))


def constrain(x, *logical_axes: str | None):
    """Pin ``x`` to its logical axes' sharding under the active mesh.

    ``x`` itself without a mesh, or where ``x.ndim`` is not the number of
    axes, as in the reference. A DTensor is redistributed to the spec's
    placements on the mesh's ``DeviceMesh``. A plain tensor under a mesh
    of one rank is returned as it is (one rank shards nothing); under a
    larger mesh it raises: the program over several ranks places every
    tensor (``shard_tree``, ``launch.dryrun.mesh_cell``), so a plain
    activation there escaped placement."""
    mesh, rules = _get_ctx()
    if mesh is None or x.ndim != len(logical_axes):
        return x
    from torch.distributed.tensor import DTensor
    if isinstance(x, DTensor):
        if mesh.device_mesh is None:
            raise ValueError(f"a DTensor under {mesh}: the mesh has no "
                             "DeviceMesh")
        sharding = named_sharding(x.shape, logical_axes, mesh, rules)
        return x.redistribute(mesh.device_mesh, sharding.placements())
    if mesh.size == 1:
        return x
    raise NotImplementedError(
        f"constrain: a plain tensor of shape {tuple(x.shape)} under {mesh}: "
        f"nothing placed it (shard_tree places the model's tensors; "
        f"{NEXT_SLICE})")


# ---------------------------------------------------------------------------
# the program over placed tensors: index tensors, local steps
# ---------------------------------------------------------------------------

def is_placed(x) -> bool:
    """Whether ``x`` is a DTensor (the model runs over a mesh)."""
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def lift(t, like):
    """``t``, a plain tensor made inside the model (a table of
    frequencies, a mask), replicated on the mesh of ``like`` when that is
    a DTensor; else ``t`` itself. Each rank made the same ``t``."""
    if not is_placed(like):
        return t
    from torch.distributed.tensor import DTensor, Replicate
    dm = like.device_mesh
    return DTensor.from_local(t, dm, [Replicate()] * dm.ndim,
                              run_check=False)


def placed_like(t, like):
    """``t``, a plain full tensor of ``like``'s shape made the same on
    every rank (positions from the tokens), at ``like``'s placements when
    that is a DTensor (each rank keeps its slice); else ``t`` itself."""
    if not is_placed(like):
        return t
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(t, like.device_mesh, like.placements,
                             src_data_rank=None)


def _active_device_mesh():
    mesh, rules = _get_ctx()
    if mesh is None or mesh.device_mesh is None:
        raise ValueError("no mesh with a DeviceMesh is active (use_mesh)")
    return mesh, rules


def placements(shape: Sequence[int], logical_axes: Sequence[str | None]
               ) -> tuple:
    """The active mesh's DTensor placements of a ``shape`` tensor on its
    logical axes under the active rules."""
    mesh, rules = _active_device_mesh()
    return named_sharding(shape, logical_axes, mesh, rules).placements()


def placed_zeros(shape: Sequence[int], logical_axes, dtype, device):
    """Zeros of ``shape`` placed on the active mesh at its axes'
    placements, each rank allocating only its shard."""
    import torch
    from torch.distributed.tensor import DTensor
    mesh, rules = _active_device_mesh()
    sharding = named_sharding(shape, logical_axes, mesh, rules)
    local = torch.zeros(sharding.shard_shape(shape), dtype=dtype,
                        device=device)
    return DTensor.from_local(local, mesh.device_mesh, sharding.placements(),
                              run_check=False, shape=tuple(shape),
                              stride=_contiguous_strides(shape))


def _contiguous_strides(shape: Sequence[int]) -> tuple[int, ...]:
    out, acc = [], 1
    for dim in reversed(tuple(shape)):
        out.append(acc)
        acc *= dim
    return tuple(reversed(out))


def shard_offset(x, dim: int) -> tuple[int, int | None]:
    """(the global offset of this rank's shard along ``dim``, the mesh
    dimension that shards it, or None where no mesh dimension of more
    than one rank does) of the DTensor ``x``, evenly sharded; a dimension
    sharded over several mesh axes is refused."""
    dims = [i for i, p in enumerate(x.placements)
            if p.is_shard(dim) and x.device_mesh.size(i) > 1]
    if not dims:
        return 0, None
    if len(dims) > 1:
        raise NotImplementedError(f"dim {dim} sharded over the mesh "
                                  f"dimensions {dims}")
    i = dims[0]
    coord = x.device_mesh.get_coordinate()[i]
    return coord * (x.shape[dim] // x.device_mesh.size(i)), i


def keep_shard(placements: Sequence, dim: int) -> tuple:
    """``placements`` with every entry that is not ``Shard(dim)`` made
    ``Replicate()``: a tensor whole but for its ``dim``."""
    from torch.distributed.tensor import Replicate
    return tuple(p if p.is_shard(dim) else Replicate() for p in placements)


def replicate(x) -> tuple:
    """``Replicate()`` on every mesh dimension of the DTensor ``x``'s mesh
    (the placements of a tensor whole on every rank)."""
    from torch.distributed.tensor import Replicate
    return (Replicate(),) * x.device_mesh.ndim


def all_gather(t, dim: int, device_mesh, mesh_dim: int):
    """The ranks' ``t`` along mesh dimension ``mesh_dim`` concatenated on
    ``dim`` in rank order (one all-gather)."""
    import torch.distributed._functional_collectives as fc
    # all_gather_single where this torch has it (all_gather_tensor's name
    # from 2.12 on; the two are one function)
    gather = getattr(fc, "all_gather_single", fc.all_gather_tensor)
    return fc.wait_tensor(gather(t, dim, (device_mesh, mesh_dim)))


def all_reduce(t, device_mesh, mesh_dim: int, op: str = "sum"):
    """The sum (or ``op``: "max", ...) of the ranks' ``t`` along mesh
    dimension ``mesh_dim`` (one all-reduce)."""
    import torch.distributed._functional_collectives as fc
    return fc.wait_tensor(fc.all_reduce(t, op, (device_mesh, mesh_dim)))


def permute(t, device_mesh, mesh_dim: int, dst: Sequence[int]):
    """Each rank's ``t`` sent to rank ``dst[i]`` (rank i along mesh
    dimension ``mesh_dim``) and the one sent to it returned (one
    collective permute)."""
    import torch.distributed._functional_collectives as fc
    # flat: permute_tensor splits the first dim by the tensor's numel
    out = fc.permute_tensor(t.reshape(-1), list(dst), (device_mesh, mesh_dim))
    return fc.wait_tensor(out).view(t.shape)


def shard_on(placements: Sequence, dim: int, mesh_dim: int) -> tuple:
    """``placements`` with ``Shard(dim)`` on mesh dimension ``mesh_dim``."""
    from torch.distributed.tensor import Shard
    return tuple(Shard(dim) if i == mesh_dim else p
                 for i, p in enumerate(placements))


def local_map(fn, out_placements, in_placements, *args):
    """``fn`` on the local shards of ``args`` (DTensors redistributed to
    ``in_placements`` first, one entry a flattened argument, None for a
    plain one), its output wrapped at ``out_placements`` (one output's
    placements, or a tuple of them for several outputs)
    (``torch.distributed.tensor.experimental.local_map``)."""
    from torch.distributed.tensor import Placement
    from torch.distributed.tensor.experimental import local_map as lm
    if all(isinstance(p, Placement) for p in out_placements):
        out_placements = list(out_placements)   # one output
    return lm(fn, out_placements=out_placements, in_placements=in_placements,
              redistribute_inputs=True)(*args)


def over_heads(fn, out_dims, in_dims, *args, heads: int):
    """``fn(lo, *local)`` on each rank's heads under the active mesh and
    rules: ``heads`` heads on the logical axis "ssm_heads" (whole where
    they do not divide its mesh axes, the rules' fallback), the batch on
    "batch". Every argument and output of ``fn`` has its batch at dim 0
    and its heads at the dim that ``in_dims`` / ``out_dims`` give (None:
    whole over the heads), or, where an entry is a pair, its (batch,
    heads) dims (None: it has none); one ``out_dims`` entry is one
    output. ``lo`` is the first of this rank's heads."""
    from torch.distributed.tensor import Replicate, Shard
    dm = args[0].device_mesh
    pl = placements((args[0].shape[0], heads), ("batch", "ssm_heads"))
    lo = 0
    for i, p in enumerate(pl):
        if p.is_shard(1):
            lo = lo * dm.size(i) + dm.get_coordinate()[i]
    lo *= heads // math.prod(dm.size(i) for i, p in enumerate(pl)
                             if p.is_shard(1))

    def at(entry):
        bdim, hdim = entry if isinstance(entry, tuple) else (0, entry)
        return tuple(Shard(bdim) if p.is_shard(0) and bdim is not None else
                     Shard(hdim) if p.is_shard(1) and hdim is not None else
                     Replicate() for p in pl)

    outs = at(out_dims[0]) if len(out_dims) == 1 else tuple(
        at(d) for d in out_dims)
    return local_map(lambda *local: fn(lo, *local), outs,
                     tuple(at(d) for d in in_dims), *args)


def _axes_leaf(x) -> bool:
    """An axes leaf is None or a flat tuple of axis names (not a NamedTuple
    of sub-trees — those have tuple-valued fields and recurse)."""
    return x is None or (
        isinstance(x, tuple)
        and all(e is None or isinstance(e, str) for e in x))


def _children(shapes, tree, path: str):
    """(key, shapes child, tree child) of a dict or NamedTuple node; a
    module's shapes are its named parameters."""
    if hasattr(shapes, "named_parameters"):
        shapes = dict(shapes.named_parameters())
    if isinstance(tree, dict):
        if set(tree) != set(shapes):
            raise ValueError(f"{path or 'root'}: the axes and the tensors "
                             f"differ in {sorted(set(tree) ^ set(shapes))}")
        return [(k, shapes[k], tree[k]) for k in tree]
    if hasattr(tree, "_fields"):
        return [(f, getattr(shapes, f), getattr(tree, f))
                for f in tree._fields]
    raise TypeError(f"{path or 'root'}: {type(tree).__name__} is no tree")


def tree_shardings(shapes_tree: Any, axes_tree: Any, mesh: Mesh,
                   rules: Mapping[str, Any] | None = None) -> Any:
    """Map a tree of tensors (meta stand-ins or real; a module's are its
    named parameters) and a matching axes tree to ``NamedSharding``s of
    the axes tree's structure. A None leaf is replicated."""
    rules = rules or DEFAULT_RULES

    def one(shapes, axes, path):
        if _axes_leaf(axes):
            if axes is None:
                return NamedSharding(mesh, ())
            return named_sharding(shapes.shape, axes, mesh, rules)
        kids = {k: one(s, a, f"{path}/{k}")
                for k, s, a in _children(shapes, axes, path)}
        return kids if isinstance(axes, dict) else type(axes)(**kids)

    return one(shapes_tree, axes_tree, "")


def _map_tree(tensors: Any, axes: Any, fn, path: str = "") -> Any:
    """``fn(tensor, axes)`` at every leaf of ``tensors`` beside its axes
    tree, in the tree's structure. A module (its axes keyed by dotted
    parameter names) comes back as a new module of the same classes
    holding the results as frozen parameters; the given one is left as
    it was."""
    if _axes_leaf(axes):
        return fn(tensors, axes)
    if hasattr(tensors, "named_parameters"):
        names = {n for n, _ in tensors.named_parameters()}
        if names != set(axes):
            raise ValueError(f"{path or 'root'}: the axes and the "
                             f"parameters differ in "
                             f"{sorted(names ^ set(axes))}")
        return _map_module(tensors, axes, fn, "")
    kids = {k: _map_tree(t, a, fn, f"{path}/{k}")
            for k, t, a in _children(tensors, axes, path)}
    return kids if isinstance(axes, dict) else type(axes)(**kids)


def _map_module(module, axes: dict, fn, prefix: str):
    from torch import nn
    new = type(module).__new__(type(module))
    nn.Module.__init__(new)
    for name, p in module._parameters.items():
        new.register_parameter(name, nn.Parameter(
            fn(p, axes[prefix + name]), requires_grad=False))
    for name, child in module._modules.items():
        new.add_module(name, _map_module(child, axes, fn,
                                         f"{prefix}{name}."))
    return new


def shard_tree(tensors: Any, axes: Any, mesh: Mesh,
               rules: Mapping[str, Any] | None = None) -> Any:
    """Place a tree of full tensors, the same on every rank of ``mesh``,
    as DTensors on its ``DeviceMesh``, each leaf at its axes' placements
    (``tree_shardings``); each rank keeps its own slice, so nothing is
    sent. A module comes back as a copy whose parameters are DTensors. A
    leaf that is a DTensor at its placements already stays as it is."""
    from torch.distributed.tensor import distribute_tensor
    if mesh.device_mesh is None:
        raise ValueError(f"shard_tree: {mesh} has no DeviceMesh")
    rules = rules or DEFAULT_RULES

    def place(t, leaf_axes):
        spec = (NamedSharding(mesh, ()) if leaf_axes is None else
                named_sharding(t.shape, leaf_axes, mesh, rules))
        if is_placed(t):  # placed already (a prefill's cache): as it is
            if t.device_mesh != mesh.device_mesh or \
                    tuple(t.placements) != spec.placements():
                raise ValueError(f"a DTensor at {t.placements} where its "
                                 f"axes {leaf_axes} give {spec.placements()}")
            return t
        return distribute_tensor(t.detach(), mesh.device_mesh,
                                 spec.placements(), src_data_rank=None)

    return _map_tree(tensors, axes, place)


def gather_tree(tree: Any) -> Any:
    """Each DTensor leaf of a dict, NamedTuple or module tree as its full
    tensor (``full_tensor()``, a collective), a plain leaf as it is:
    for checks. A module comes back as a dict of its dotted names."""
    from torch.distributed.tensor import DTensor

    def full(t):
        return t.full_tensor() if isinstance(t, DTensor) else t

    if hasattr(tree, "named_parameters"):
        return {n: full(p) for n, p in tree.named_parameters()}
    if isinstance(tree, dict):
        return {k: gather_tree(v) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(gather_tree(v) for v in tree))
    return full(tree)


def sharded_leaves(shapes_tree: Any, shardings_tree: Any,
                   path: str = ""):
    """(path, tensor, ``NamedSharding``) of every leaf of a
    ``tree_shardings`` result beside its tensors."""
    if isinstance(shardings_tree, NamedSharding):
        yield path, shapes_tree, shardings_tree
        return
    for k, s, t in _children(shapes_tree, shardings_tree, path):
        yield from sharded_leaves(s, t, f"{path}/{k}" if path else k)

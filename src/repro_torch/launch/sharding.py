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

# what a plain tensor under a mesh of several ranks waits for
NEXT_SLICE = ("the LM's tensors placed over several ranks (ROADMAP.md, "
              "Queue 1, item 1: the sharded LM)")

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
    larger mesh it raises, since nothing places the LM's tensors over
    several ranks yet."""
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
        f"constrain: a plain tensor of shape {tuple(x.shape)} under {mesh}; "
        f"this waits for {NEXT_SLICE}")


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


def sharded_leaves(shapes_tree: Any, shardings_tree: Any,
                   path: str = ""):
    """(path, tensor, ``NamedSharding``) of every leaf of a
    ``tree_shardings`` result beside its tensors."""
    if isinstance(shardings_tree, NamedSharding):
        yield path, shapes_tree, shardings_tree
        return
    for k, s, t in _children(shapes_tree, shardings_tree, path):
        yield from sharded_leaves(s, t, f"{path}/{k}" if path else k)

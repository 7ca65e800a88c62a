"""Cost analysis of one step, op by op (the counterpart of
``repro/launch/hlo_analysis.py``; the port has no HLO).

The reference re-derives FLOPs and bytes from a compiled step's HLO text.
The port's step is eager torch, so ``CostCounter``, a
``TorchDispatchMode``, sees every aten op as it runs, after autograd and
``torch.utils.checkpoint`` have decided what runs: the backward and a
remat unit's recompute are counted where they run, and a Python loop over
L layers is counted L times (the reference's trip counts). It is meant
for the meta device (``launch/dryrun.py``), where the ops run on shapes
alone and allocate nothing: by design, not as a fallback from a card,
which the dry-run never touches. It counts a CPU or CUDA step alike.

Per op it records:

- FLOPs: the matmul family (``mm``, ``bmm``, ``addmm``, ``baddbmm``,
  convolution, ...) by ``torch.utils.flop_counter``'s formulas; any
  other op that launches work 1 FLOP per output element, as the
  reference charges a fusion;
- bytes (``op_bytes``): its inputs read and its outputs written once. In
  eager torch each op boundary is a round trip through HBM, so this is the
  analogue of the reference's fusion-boundary bytes. A gather reads only
  the rows it gathers and a scatter writes only the rows it writes (the
  reference's dynamic-slice rule); a broadcast input is read once.
  Views, metadata ops and allocations cost nothing;
- the count of ops that launch work, by name;
- the live storages: each one's bytes from the op that makes it until
  it is freed (a weakref callback on the storage, whose Python object
  lives exactly as long as the storage), so ``peak_live_bytes`` is the
  step's high-water mark over the tensors given as live at the start.

A port kernel on the meta device records its own ``roofline.kernel_cost``
as one op (``record_kernel``), never its plain twin's ops.

On the meta device an op's result depends on its arguments' shapes,
strides and dtypes alone, so a functional op's outputs and a composite
op's record (its ops and its peak) are kept by that metadata and rebuilt
when the same op comes again (the next layer, the next attention block):
the counts are those of running it, at a fraction of the Python meta
kernels' time.

The compulsory traffic ``min_bytes`` and the ``static_bytes`` of
parameters, optimizer state and caches are the caller's (``dryrun``
knows what is a parameter, a cache or an input); ``tree_bytes`` sums a
tree's distinct storages.
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass, field

import torch
from torch.utils.flop_counter import flop_registry

from repro_torch.launch import roofline as rl

# ops that only make a view or allocate: no launch, no bytes (an op that
# returns no tensor costs nothing either)
FREE_OPS = frozenset({
    "view", "_unsafe_view", "expand", "permute", "transpose", "t", "slice",
    "select", "as_strided", "alias", "detach", "squeeze", "unsqueeze",
    "split", "split_with_sizes", "unbind", "narrow", "_reshape_alias",
    "view_as_real", "view_as_complex", "unfold", "diagonal", "lift_fresh",
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
    "resize_", "set_", "detach_", "t_", "transpose_", "squeeze_",
    "unsqueeze_", "as_strided_", "real", "imag", "conj", "_conj",
    "_neg_view",
})
# the ops torch.utils.flop_counter has formulas for (its registry's names)
MATMUL_OPS = frozenset(k.__name__ for k in flop_registry
                       if hasattr(k, "__name__"))
# gathers: the gathered rows read, the output written, the indices read
GATHER_OPS = frozenset({"index", "index_select", "gather", "embedding",
                        "take", "_unsafe_index"})
# scatters into their first argument: the written rows read from the
# source and written, the indices read
SCATTER_OPS = frozenset({"index_copy_", "index_copy", "index_put_",
                         "index_put", "_index_put_impl_", "scatter_",
                         "scatter", "scatter_add_", "scatter_add",
                         "index_add_", "index_add", "masked_scatter_",
                         "index_fill_", "index_fill"})
# in-place ops that write their first argument without reading it
WRITE_ONLY = frozenset({"copy_", "fill_", "zero_", "normal_", "uniform_",
                        "random_", "bernoulli_", "exponential_"})


def read_bytes(t: torch.Tensor) -> int:
    """Bytes of ``t``'s distinct elements: a broadcast (stride-0) axis is
    read once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def tree_bytes(*trees) -> int:
    """Bytes of the distinct storages under ``trees`` (tensors, modules,
    dicts, lists, NamedTuples)."""
    storages = {}
    for t in _flat(trees):
        s = t.untyped_storage()
        storages[id(s)] = s.nbytes()
    return sum(storages.values())


@dataclass
class Costs:
    """What ``CostCounter`` counted over one step."""
    flops: float = 0.0
    op_bytes: float = 0.0
    min_bytes: float = 0.0
    static_bytes: int = 0
    peak_live_bytes: int = 0
    ops: dict = field(default_factory=dict)       # op name -> launches
    kernels: dict = field(default_factory=dict)   # port kernel -> launches
    flops_by_op: dict = field(default_factory=dict)
    bytes_by_op: dict = field(default_factory=dict)

    @property
    def matmul_flops(self) -> float:
        """The FLOPs of the matmul family (``flop_counter``'s formulas)."""
        return sum(v for k, v in self.flops_by_op.items() if k in MATMUL_OPS)

    @property
    def launches(self) -> int:
        return sum(self.ops.values())

    def top_bytes(self, n: int = 5) -> list[tuple[str, float]]:
        """The ops with the most ``op_bytes``, largest first."""
        return sorted(self.bytes_by_op.items(), key=lambda kv: -kv[1])[:n]

    def to_dict(self) -> dict:
        """The counts a dry-run cell's JSON keeps (ops most-launched
        first)."""
        return {"flops": self.flops, "op_bytes": self.op_bytes,
                "min_bytes": self.min_bytes,
                "static_bytes": self.static_bytes,
                "peak_live_bytes": self.peak_live_bytes,
                "launches": self.launches,
                "ops": dict(sorted(self.ops.items(), key=lambda kv: -kv[1])),
                "kernels": dict(self.kernels)}


_ACTIVE: list["CostCounter"] = []


def active() -> "CostCounter | None":
    """The innermost ``CostCounter`` running, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


def record_kernel(name: str, **shape) -> None:
    """Record one launch of the port kernel ``name`` at ``shape`` on the
    active counter (a no-op without one): ``roofline.kernel_cost``'s
    bytes and ops, as one op."""
    counter = active()
    if counter is not None:
        nbytes, ops, _ = rl.kernel_cost(name, **shape)
        counter._add(name, float(ops), float(nbytes))
        counter.costs.kernels[name] = counter.costs.kernels.get(name, 0) + 1


class CostCounter(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts the aten ops run under it (see the module docstring).

    ``live``: trees of the tensors alive when the step starts
    (parameters, optimizer state, caches, inputs), counted in the live
    bytes from the start. ``live_positions``: the positions a decode
    step's cache rows hold (the meta device has no position values), read
    by a kernel that records its cost."""

    def __init__(self, live=(), live_positions: int | None = None):
        super().__init__()
        self.costs = Costs()
        self.live_positions = live_positions
        self._live: dict[int, tuple[weakref.ref, int]] = {}
        self._live_bytes = 0
        # the composite ops being recorded: (their ops, [high-water bytes])
        self._recording: list[tuple[list, list]] = []
        for t in _flat(live):
            self._track(t)
        self.costs.peak_live_bytes = self._live_bytes

    # -- live storages
    def _track(self, t: torch.Tensor) -> None:
        s = t.untyped_storage()
        key = id(s)
        if key in self._live:
            return
        nbytes = s.nbytes()

        def freed(_, key=key, nbytes=nbytes, live=self._live):
            if live.pop(key, None) is not None:
                self._live_bytes -= nbytes

        self._live[key] = (weakref.ref(s, freed), nbytes)
        self._live_bytes += nbytes

    # -- counting
    def _add(self, name: str, flops: float, nbytes: float) -> None:
        c = self.costs
        c.flops += flops
        c.op_bytes += nbytes
        c.ops[name] = c.ops.get(name, 0) + 1
        c.flops_by_op[name] = c.flops_by_op.get(name, 0.0) + flops
        c.bytes_by_op[name] = c.bytes_by_op.get(name, 0.0) + nbytes
        for ops, _ in self._recording:
            ops.append((name, flops, nbytes))

    def _high_water(self) -> None:
        live = self._live_bytes
        if live > self.costs.peak_live_bytes:
            self.costs.peak_live_bytes = live
        for _, hw in self._recording:
            if live > hw[0]:
                hw[0] = live

    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func not in _ATOMIC:
            # a composite op (einsum, matmul, to, ...: seen whole under
            # inference mode) is counted as the ops it decomposes into, as
            # they run; on the meta device, replayed from its first run at
            # the same arguments' metadata
            key = _meta_key(func, args, kwargs)
            seen = _COMPOSITE.get(key) if key is not None else None
            if seen is not None:
                return self._replay(*seen)
            ops, hw, start = [], [self._live_bytes], self._live_bytes
            self._recording.append((ops, hw))
            try:
                with self:
                    out = func.decompose(*args, **kwargs)
            finally:
                self._recording.pop()
            if out is not NotImplemented:
                layouts = _layouts(out, args) if key is not None else None
                if layouts is not None:
                    _COMPOSITE[key] = (*layouts, tuple(ops), hw[0] - start)
                return out
            _ATOMIC.add(func)
        out = _run(func, args, kwargs)
        outs = _flat(out)
        for t in outs:
            self._track(t)
        self._high_water()
        name = func.overloadpacket.__name__
        if name in FREE_OPS or not outs:
            return out
        if func.overloadpacket in flop_registry:
            flops = float(flop_registry[func.overloadpacket](
                *args, **kwargs, out_val=out))
            nbytes = _plain_bytes(name, _flat(args), outs)
        elif name in SCATTER_OPS:
            flops, nbytes = _scatter_cost(name, args)
        elif name in GATHER_OPS:
            # the gathered rows read, the output written, the indices read
            flops = float(sum(t.numel() for t in outs))
            nbytes = 2.0 * sum(read_bytes(t) for t in outs) + sum(
                read_bytes(t) for t in _flat(args[1:]))
        else:
            flops = float(sum(t.numel() for t in outs))
            nbytes = _plain_bytes(name, _flat((args, kwargs)), outs)
        self._add(name, flops, nbytes)
        return out

    def _replay(self, single, metas, ops, transient):
        """A composite op's recorded ops added again, its peak above the
        live bytes, and fresh outputs of its recorded layout."""
        for name, flops, nbytes in ops:
            self._add(name, flops, nbytes)
        live = self._live_bytes
        self._live_bytes += transient
        self._high_water()
        self._live_bytes = live
        out = _fresh(single, metas)
        for t in _flat(out):
            self._track(t)
        return out


# ops known to have no composite decomposition (filled as they are met)
_ATOMIC = {torch.ops.prim.device.default}
# on the meta device an op's result is a function of its arguments'
# shapes, strides and dtypes alone, many of torch's meta kernels are
# Python, and a step's L identical layers repeat the same ops L times: so
# a functional op's outputs, and a composite op's record, are kept by its
# arguments' metadata and rebuilt from it
_META_OUT: dict = {}     # key -> (one tensor?, output layouts)
_COMPOSITE: dict = {}    # key -> (one tensor?, layouts, its ops, its peak)


def _key(x):
    if isinstance(x, torch.Tensor):
        if not x.is_meta:
            raise TypeError
        return (tuple(x.shape), x.stride(), x.dtype, x.storage_offset())
    if isinstance(x, (list, tuple)):
        return tuple(_key(y) for y in x)
    if isinstance(x, dict):
        return tuple(sorted((k, _key(v)) for k, v in x.items()))
    hash(x)
    return x


def _meta_key(func, args, kwargs):
    """``func`` and its arguments' metadata when every tensor argument is
    a meta tensor and the op writes none of them, else None."""
    if func._schema.is_mutable:
        return None
    try:
        return (func, _key(args), _key(kwargs))
    except TypeError:
        return None


def _layouts(out, args):
    """(one tensor?, each output's layout) when ``out`` is meta tensors of
    storages of their own (no view of an argument, none shared), else
    None."""
    single = isinstance(out, torch.Tensor)
    outs = [out] if single else out
    if not isinstance(outs, (list, tuple)) or not all(
            isinstance(t, torch.Tensor) and t.is_meta for t in outs):
        return None
    taken = {id(t.untyped_storage()) for t in _flat(args)}
    metas = []
    for t in outs:
        s = t.untyped_storage()
        if id(s) in taken:
            return None
        taken.add(id(s))
        metas.append((tuple(t.shape), t.stride(), t.dtype,
                      t.storage_offset(), s.nbytes()))
    return single, metas


def _fresh(single, metas):
    """New meta tensors of the recorded layouts."""
    outs = [torch.empty((nbytes // dtype.itemsize,), dtype=dtype,
                        device="meta").as_strided(shape, stride, offset)
            for shape, stride, dtype, offset, nbytes in metas]
    return outs[0] if single else tuple(outs)


def _run(func, args, kwargs):
    """``func(*args, **kwargs)``; on the meta device a functional op's
    outputs are rebuilt from its first run's layouts."""
    if func.overloadpacket.__name__ in FREE_OPS or any(
            r.alias_info is not None for r in func._schema.returns):
        return func(*args, **kwargs)
    key = _meta_key(func, args, kwargs)
    if key is None:
        return func(*args, **kwargs)
    seen = _META_OUT.get(key)
    if seen is not None:
        return _fresh(*seen)
    out = func(*args, **kwargs)
    layouts = _layouts(out, args)
    if layouts is not None:
        _META_OUT[key] = layouts
    return out


def _flat(tree) -> list[torch.Tensor]:
    """The tensors of ``tree``: a tensor, a module's parameters and
    buffers, or lists, tuples (NamedTuples too) and dicts of them."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, torch.nn.Module):
        return [*tree.parameters(), *tree.buffers()]
    if isinstance(tree, dict):
        tree = list(tree.values())
    out = []
    if isinstance(tree, (list, tuple)):
        for x in tree:
            if isinstance(x, torch.Tensor):
                out.append(x)
            elif isinstance(x, (list, tuple, dict, torch.nn.Module)):
                out.extend(_flat(x))
    return out


def _plain_bytes(name: str, ins, outs) -> float:
    """Each distinct input read once (an in-place op's first argument
    not read where the op only writes it), each output written once."""
    seen = {id(ins[0])} if name in WRITE_ONLY and ins else set()
    total = 0
    for t in ins:
        if id(t) not in seen:
            seen.add(id(t))
            total += read_bytes(t)
    return float(total + sum(read_bytes(t) for t in outs))


def _scatter_cost(name: str, args) -> tuple[float, float]:
    """(FLOPs, bytes) of a scatter into ``args[0]``: the rows it writes
    read from the source and written, the indices read."""
    if name.startswith("index_put") or name == "_index_put_impl_":
        idx, src = _flat(args[1]), args[2]            # (self, indices, values)
    elif name == "masked_scatter_":
        idx, src = [args[1]], args[2]                 # (self, mask, source)
    else:
        idx, src = [args[2]], args[3] if len(args) > 3 else None
    if isinstance(src, torch.Tensor):
        n, nbytes = src.numel(), read_bytes(src)
    else:                                             # a scalar fill
        n = max(t.numel() for t in idx)
        nbytes = n * args[0].element_size()
    return float(n), 2.0 * nbytes + sum(read_bytes(t) for t in idx)


def count(fn, *args, live=(), live_positions: int | None = None,
          **kwargs) -> tuple[object, Costs]:
    """Run ``fn(*args, **kwargs)`` under a ``CostCounter``: (its result,
    the costs). ``live`` and ``live_positions`` as ``CostCounter`` takes
    them; ``static_bytes`` and ``min_bytes`` are left for the caller."""
    with CostCounter(live=live, live_positions=live_positions) as counter:
        out = fn(*args, **kwargs)
    return out, counter.costs

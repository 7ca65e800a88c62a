"""The port's logical-axis sharding (``repro_torch.launch.sharding``,
``launch/mesh.py``, every ``*_axes`` tree, ``constrain`` in the models,
the dry-run's ``--mesh pod | multipod``) against the reference's.

Specs and shard shapes are held to the reference's ``logical_to_spec``
and ``jax.sharding.NamedSharding(AbstractMesh(...), spec).shard_shape``
leaf by leaf, for the ten configs under the training and the serving
rules on five meshes, over the parameters, the optimizer state, every
cache kind and the batch; the dry-run's per-device bytes are held to the
sums over the reference's own ``build_cell`` shardings. A stacked layer
is a list entry in the port: its axes omit the reference's leading
"stack", which every rules table replicates, so the port's spec is the
reference's less that entry. ``constrain`` is held on meta DTensors over
a fake 256- and 512-rank process group, on a (2, 2) gloo mesh of four
processes (``tests/_torch_dist_harness.py``), and the models under a
(1, 1) CPU mesh bit for bit against themselves without one.
"""
import functools
import os
import pathlib
import socket
import subprocess
import sys
import threading

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh
from jax.sharding import NamedSharding as JNamedSharding

from repro import configs as jconfigs
from repro.launch import sharding as jshd
from repro.models import model as jmodel
from repro.train import optimizer as jopt
from repro_torch import configs as tconfigs
from repro_torch.launch import dryrun as tdry
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import sharding as tshd
from repro_torch.models import layers as tll
from repro_torch.models import model as tmodel
from repro_torch.train import optimizer as topt

ARCHS = tuple(tconfigs.ALIASES)
MESHES = {
    "16x16": {"data": 16, "model": 16},
    "2x16x16": {"pod": 2, "data": 16, "model": 16},
    "1x1": {"data": 1, "model": 1},
    "2x2": {"data": 2, "model": 2},
    "4x1": {"data": 4, "model": 1},
}
# (batch, seq) of the caches and batches held: a pod's cell and a
# batch of 1 at a length no mesh axis divides (the fallback's cases)
CACHE_SIZES = ((128, 32768), (1, 1000))
BATCH_SIZES = ((256, 4096), (32, 32768), (1, 1000))
_HARNESS = pathlib.Path(__file__).with_name("_torch_dist_harness.py")


@functools.lru_cache(maxsize=None)
def _jdry():
    """The reference's ``launch/dryrun.py``, imported with ``XLA_FLAGS``
    kept as it was: the module sets a 512-device flag on import, which
    must not reach another test of this process (jax's backend is up
    first, so the flag takes no effect here either)."""
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun
    if saved is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = saved
    return dryrun


def _jmesh(shape: dict) -> AbstractMesh:
    return AbstractMesh(tuple(shape.values()), tuple(shape))


def _key(k) -> str:
    for attr in ("key", "name", "idx"):
        if hasattr(k, attr):
            return str(getattr(k, attr))
    raise TypeError(k)


def _ref_leaves(shapes, axes, mesh, rules) -> dict:
    """{reference path: (shape, spec, shard shape)} of the reference's
    ``tree_shardings``."""
    shardings = jshd.tree_shardings(shapes, axes, mesh, rules)
    paths = jax.tree_util.tree_flatten_with_path(shapes)[0]
    out = {}
    for (path, sds), sh in zip(paths, jax.tree.leaves(shardings)):
        spec = tuple(sh.spec) + (None,) * (len(sds.shape) - len(sh.spec))
        out["/".join(_key(k) for k in path)] = (
            tuple(sds.shape), spec, tuple(sh.shard_shape(sds.shape)))
    return out


def _port_leaves(tensors, axes, mesh, rules) -> dict:
    """{(reference path, layer or None): (shape, spec, shard shape)} of
    the port's ``tree_shardings``; a dotted parameter name maps to its
    reference path by ``layers.tree_key``."""
    shardings = tshd.tree_shardings(tensors, axes, mesh, rules)
    out = {}
    for path, t, sh in tshd.sharded_leaves(tensors, shardings):
        parts, layer = [], None
        for part in path.split("/"):
            key, idx = tll.tree_key(part)
            parts.append(key)
            layer = idx if idx is not None else layer
        out[("/".join(parts), layer)] = (tuple(t.shape), sh.spec,
                                         sh.shard_shape(t.shape))
    return out


def _assert_same_leaves(port: dict, ref: dict, what: str) -> None:
    assert {p for p, _ in port} == set(ref), what
    for (path, layer), (shape, spec, shard) in port.items():
        rshape, rspec, rshard = ref[path]
        if layer is None:
            assert (shape, spec, shard) == (rshape, rspec, rshard), \
                (what, path)
        else:
            # the reference's leading "stack" axis, replicated
            assert rspec[0] is None and rshard[0] == rshape[0], (what, path)
            assert (shape, spec, shard) == (rshape[1:], rspec[1:],
                                            rshard[1:]), (what, path, layer)


def _cfgs(arch: str):
    return jconfigs.get_config(arch), tconfigs.get_config(arch)


def _kinds(arch: str) -> tuple[bool, ...]:
    """The cache kinds of an arch: exact and PQ where it has attention."""
    cfg = tconfigs.get_config(arch)
    return (False,) if cfg.block_type == "rwkv6" else (False, True)


@functools.lru_cache(maxsize=None)
def _ref_trees(arch: str, kv_pq: bool) -> dict:
    jcfg = jconfigs.get_config(arch).replace(kv_pq=kv_pq)
    pshapes, paxes = jmodel.lm_shapes(jcfg), jmodel.lm_axes(jcfg)
    trees = {"param": (pshapes, paxes),
             "opt": (jopt.state_shapes(pshapes), jopt.state_axes(paxes))}
    for b, s in CACHE_SIZES:
        trees[f"cache {b}x{s}"] = (
            jax.eval_shape(lambda: jmodel.init_cache(jcfg, b, s)),
            jmodel.cache_axes(jcfg))
    for b, s in BATCH_SIZES:
        trees[f"batch {b}x{s}"] = _jdry().batch_specs(jcfg, b, s)
    return trees


@functools.lru_cache(maxsize=None)
def _port_trees(arch: str, kv_pq: bool) -> dict:
    tcfg = tconfigs.get_config(arch).replace(kv_pq=kv_pq)
    params, paxes = tmodel.lm_shapes(tcfg), tmodel.lm_axes(tcfg)
    trees = {"param": (params, paxes),
             "opt": (topt.state_shapes(params), topt.state_axes(paxes))}
    for b, s in CACHE_SIZES:
        trees[f"cache {b}x{s}"] = (
            tmodel.init_cache(tcfg, b, s, device="meta"),
            tmodel.cache_axes(tcfg))
    for b, s in BATCH_SIZES:
        trees[f"batch {b}x{s}"] = (tdry.batch_specs(tcfg, b, s),
                                   tdry.batch_axes(tcfg))
    return trees


# ---------------------------------------------------------------------------
# the reference's unit cases (tests/test_sharding_and_analysis.py:19-55)
# ---------------------------------------------------------------------------

def test_logical_to_spec_basic():
    mesh = tmesh.Mesh({"data": 1, "model": 1})
    spec = tshd.logical_to_spec((8, 16), ("batch", "mlp"), mesh,
                                tshd.DEFAULT_RULES)
    # data/model axes of size 1 divide everything
    assert spec == ("data", "model")
    assert spec == tuple(jshd.logical_to_spec(
        (8, 16), ("batch", "mlp"), _jmesh(mesh.shape), jshd.DEFAULT_RULES))


def test_divisibility_fallback_replicates():
    rules = {"heads": "model", None: None}
    spec = tshd.logical_to_spec((14,), ("heads",),
                                tmesh.Mesh({"model": 1}), rules)
    assert spec == ("model",)
    # 14 heads on a 16-wide model axis: replicated, as the reference does
    for shape in ({"model": 16}, {"model": 7}):
        got = tshd.logical_to_spec((14,), ("heads",), tmesh.Mesh(shape),
                                   rules)
        want = jshd.logical_to_spec((14,), ("heads",), _jmesh(shape), rules)
        assert got == tuple(want) == ((None,) if shape["model"] == 16
                                      else ("model",))


def test_axis_never_reused_across_dims():
    mesh = tmesh.Mesh({"data": 1, "model": 1})
    rules = {"batch": ("data",), "embed": "data", None: None}
    spec = tshd.logical_to_spec((4, 8), ("batch", "embed"), mesh, rules)
    # embed wanted "data" but batch already consumed it
    assert spec == ("data", None)


def test_tree_shardings_handles_namedtuples_and_none():
    mesh = tmesh.Mesh({"data": 1, "model": 1})
    pshapes = {"w": torch.empty((8, 8), device="meta")}
    paxes = {"w": ("embed", "mlp")}
    st = topt.AdamWState(torch.empty((), dtype=torch.int32, device="meta"),
                         pshapes, pshapes)
    out = tshd.tree_shardings(st, topt.state_axes(paxes), mesh)
    assert isinstance(out, topt.AdamWState)
    assert out.step.spec == ()
    assert out.mu["w"].spec == ("data", "model")


def test_constrain_noop_without_mesh():
    x = torch.ones((4, 4))
    assert tshd.constrain(x, "batch", "embed") is x
    # the wrong number of axes under a mesh: x itself, as the reference
    with tshd.use_mesh(tmesh.Mesh({"data": 2, "model": 2})):
        assert tshd.constrain(x, "batch") is x


# ---------------------------------------------------------------------------
# the rules, the meshes, every leaf's spec and shard shape
# ---------------------------------------------------------------------------

def test_the_rules_and_the_production_meshes_are_the_references():
    assert tshd.DEFAULT_RULES == jshd.DEFAULT_RULES
    assert list(tshd.DEFAULT_RULES) == list(jshd.DEFAULT_RULES)
    pod, multi = (tmesh.make_production_mesh(multi_pod=m)
                  for m in (False, True))
    assert pod.shape == {"data": 16, "model": 16} and pod.size == 256
    assert multi.shape == {"pod": 2, "data": 16, "model": 16}
    assert multi.size == 512 and multi.device_mesh is None
    # no process group: the host mesh is one rank's description
    assert not dist.is_initialized()
    host = tmesh.make_host_mesh()
    assert host.shape == {"data": 1, "model": 1} and host.device_mesh is None
    with pytest.raises(ValueError):
        tmesh.make_host_mesh(model=2)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_axes_are_the_references(arch):
    """Every parameter's logical axes: the reference's, less its leading
    "stack" on a stacked layer's leaves (and the init rule and scale of
    the spec alike)."""
    jcfg, tcfg = _cfgs(arch)
    jaxes = jax.tree_util.tree_flatten_with_path(
        jmodel.lm_axes(jcfg), is_leaf=jshd._axes_leaf)[0]
    ref = {"/".join(_key(k) for k in path): a for path, a in jaxes}
    jspecs = jax.tree_util.tree_flatten_with_path(
        jmodel.lm_specs(jcfg), is_leaf=lambda x: hasattr(x, "axes"))[0]
    rspec = {"/".join(_key(k) for k in path): s for path, s in jspecs}
    seen, axes = set(), tmodel.lm_axes(tcfg)
    for name, spec in tll.spec_items(tmodel.lm_specs(tcfg)):
        key, layer = tll.tree_key(name)
        want = ref[key][1:] if layer is not None else ref[key]
        assert spec.axes == want == axes[name], name
        assert (spec.init, spec.scale) == (rspec[key].init,
                                           rspec[key].scale), name
        if layer is not None:
            assert ref[key][0] == "stack"
        seen.add(key)
    assert seen == set(ref)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("rules", ["train", "serving"])
@pytest.mark.parametrize("arch", ARCHS)
def test_every_leafs_spec_and_shard_shape_are_the_references(arch, rules,
                                                             mesh):
    """Each tree under the rules the reference's cells apply to it: the
    parameters and the batch (three sizes) under both, the optimizer
    state under the training rules (``DEFAULT_RULES``), each cache kind
    (exact and PQ, the hybrid's shared attention exact and PQ, RWKV; two
    sizes) under the serving rules of the cell's config."""
    tm, jm = tmesh.Mesh(MESHES[mesh]), _jmesh(MESHES[mesh])
    for kv_pq in _kinds(arch):
        if rules == "train":
            trules, jrules = tshd.DEFAULT_RULES, jshd.DEFAULT_RULES
        else:
            jcfg, tcfg = (c.replace(kv_pq=kv_pq) for c in _cfgs(arch))
            trules = tdry.serving_rules(tcfg, tm)
            jrules = _jdry().serving_rules(jcfg, jm)
            assert trules == jrules
        ref, port = _ref_trees(arch, kv_pq), _port_trees(arch, kv_pq)
        assert set(ref) == set(port)
        for role, (tensors, axes) in port.items():
            kind = role.split()[0]
            if kv_pq and kind != "cache":
                continue   # the same trees as with the exact cache
            if kind == {"train": "cache", "serving": "opt"}[rules]:
                continue   # no cell of these rules holds this tree
            _assert_same_leaves(_port_leaves(tensors, axes, tm, trules),
                                _ref_leaves(*ref[role], jm, jrules),
                                f"{arch} {rules} {mesh} pq={kv_pq} {role}")


# ---------------------------------------------------------------------------
# NamedSharding, use_mesh, constrain
# ---------------------------------------------------------------------------

def test_shard_shape_and_placements():
    mesh = tmesh.make_production_mesh(multi_pod=True)
    sh = tshd.NamedSharding(mesh, (("pod", "data"), "model"))
    assert sh.shard_shape((256, 4096)) == (8, 256) == JNamedSharding(
        _jmesh(mesh.shape), jax.sharding.PartitionSpec(
            ("pod", "data"), "model")).shard_shape((256, 4096))
    from torch.distributed.tensor import Replicate, Shard
    assert sh.placements() == (Shard(0), Shard(0), Shard(1))
    assert tshd.NamedSharding(mesh, (None, "data")).placements() == (
        Replicate(), Shard(1), Replicate())
    with pytest.raises(ValueError):
        sh.shard_shape((100, 4096))
    # a dim over mesh axes out of the mesh's order is refused
    with pytest.raises(ValueError, match="order"):
        tshd.NamedSharding(mesh, (("data", "pod"),)).placements()


def test_use_mesh_is_per_thread_and_restored():
    outer, inner = (tmesh.Mesh({"data": n, "model": 1}) for n in (1, 2))
    seen = []
    with tshd.use_mesh(outer):
        with tshd.use_mesh(inner, {"batch": "data", None: None}):
            assert tshd._get_ctx() == (inner, {"batch": "data", None: None})
            t = threading.Thread(target=lambda: seen.append(
                tshd._get_ctx()))
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
        assert tshd._get_ctx() == (outer, tshd.DEFAULT_RULES)
    assert tshd._get_ctx() == (None, None) and seen == [(None, None)]


def test_a_plain_tensor_under_several_ranks_raises():
    x = torch.ones((4, 4))
    with tshd.use_mesh(tmesh.Mesh({"data": 1, "model": 1})):
        assert tshd.constrain(x, "batch", "embed") is x
    with tshd.use_mesh(tmesh.Mesh({"data": 2, "model": 2})):
        with pytest.raises(NotImplementedError, match="nothing placed it"):
            tshd.constrain(x, "batch", "embed")


def _fake_group(world: int):
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_constrain_shards_a_meta_dtensor_on_a_fake_pod(multi_pod):
    """A replicated meta DTensor on a fake 256- or 512-rank group (rank
    0) constrained to the batch, a fallback dimension and the model
    axis: its local shape is ``shard_shape``'s and the reference's."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate
    prod = tmesh.make_production_mesh(multi_pod=multi_pod)
    _fake_group(prod.size)
    try:
        mesh = tmesh.Mesh(prod.shape, init_device_mesh(
            "cpu", tuple(prod.shape.values()),
            mesh_dim_names=tuple(prod.shape)))
        # batch 16 on ("pod", "data"): the multipod mesh drops "data"
        # (16 % 32), keeping "pod"; 8 KV heads on 16: replicated
        cases = (((256, 4096, 64), ("batch", "seq", "mlp")),
                 ((16, 8, 128), ("batch", "kv_heads", "head_dim")),
                 ((16, 64, 4096), ("batch", "heads", "embed")))
        for shape, axes in cases:
            x = DTensor.from_local(torch.empty(shape, device="meta"),
                                   mesh.device_mesh,
                                   [Replicate()] * len(prod.shape),
                                   run_check=False)
            with tshd.use_mesh(mesh):
                y = tshd.constrain(x, *axes)
            want = tshd.named_sharding(shape, axes, prod)
            jspec = jshd.logical_to_spec(shape, axes, _jmesh(prod.shape),
                                         jshd.DEFAULT_RULES)
            assert want.spec == tuple(jspec)
            assert tuple(y.to_local().shape) == want.shard_shape(shape) == \
                JNamedSharding(_jmesh(prod.shape), jspec).shard_shape(shape)
        if multi_pod:
            # "data", dropped by the batch, is free for the embedding
            assert want.spec == ("pod", "model", "data")
            assert tuple(y.to_local().shape) == (8, 4, 256)
            x = DTensor.from_local(torch.empty((64, 8), device="meta"),
                                   mesh.device_mesh, [Replicate()] * 3,
                                   run_check=False)
            with tshd.use_mesh(mesh, {"batch": ("data", "pod"), None: None}):
                with pytest.raises(ValueError, match="order"):
                    tshd.constrain(x, "batch", None)
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def test_constrain_on_a_gloo_mesh_of_four_ranks():
    """``tests/_torch_dist_harness.py ... constrain`` on four gloo ranks,
    a (2, 2) CPU mesh: each rank's shard is numpy's slice, a fallback
    dimension stays whole, replicated rules gather the shards back, and a
    plain tensor raises."""
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(_HARNESS), str(rank), "4",
                               str(port), "constrain"], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True)
             for rank in range(4)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0 and out.strip().endswith("OK"), (
            f"rank failed\nstdout:\n{out}\nstderr:\n{err[-3000:]}")


# ---------------------------------------------------------------------------
# the models under a (1, 1) CPU mesh; constrain at the reference's sites
# ---------------------------------------------------------------------------

def _host_mesh():
    """A one-rank gloo group and ``make_host_mesh``'s (1, 1) CPU mesh."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    return tmesh.make_host_mesh(device="cpu")


def _record(monkeypatch, modules, real) -> list:
    """Patch each module's ``constrain`` to record the axes of every call
    whose tensor has as many dimensions as axes (the calls that pin)."""
    seen = []

    def rec(x, *axes):
        if x.ndim == len(axes):
            seen.append(axes)
        return real(x, *axes)

    for mod in modules:
        monkeypatch.setattr(mod, "constrain", rec)
    return seen


def _pinned(seen: list) -> set:
    """The axes pinned, each as a sorted tuple: the port's expert buffers
    are expert-major, (E, G, C, ...), the same axes in another order."""
    return {tuple(sorted(map(str, a))) for a in seen}


def _run(cfg, params, tokens, seen: list) -> tuple[list, dict]:
    """The forward's logits and aux, then two decode steps' logits from
    an empty exact cache; and the axes ``seen`` pinned by each path."""
    b = tokens.shape[0]
    pinned = {}
    seen.clear()
    out = list(tmodel.forward(params, tokens, cfg))
    pinned["forward"] = _pinned(seen)
    seen.clear()
    ecfg = cfg.replace(kv_pq=False)
    cache = tmodel.init_cache(ecfg, b, 8, device="cpu")
    tok = tokens[:, 0]
    for i in range(2):
        pos = torch.full((b,), i, dtype=torch.int32)
        logits, cache = tmodel.decode_step(params, cache, tok, pos, ecfg)
        out.append(logits)
        tok = torch.argmax(logits[:, :ecfg.vocab], -1)
    pinned["decode"] = _pinned(seen)
    return out, pinned


@pytest.mark.parametrize("arch", ARCHS)
def test_the_models_under_a_one_rank_mesh_are_bit_for_bit(arch,
                                                         monkeypatch):
    """The smoke config's forward and decode steps under a (1, 1) CPU
    mesh equal themselves without one bit for bit; and the set of logical
    axes each path pins equals the reference's on the same config (traced
    by ``jax.eval_shape``, where its ``constrain`` calls happen), so each
    of its 29 ``constrain`` sites has its counterpart on these paths."""
    from repro.models import layers as jl, moe as jmoe, rwkv6 as jr
    from repro.models import ssm as js, transformer as jtf
    from repro_torch.models import moe as tm, rwkv6 as tr, ssm as ts
    from repro_torch.models import transformer as ttf
    cfg = tconfigs.get_smoke_config(arch)
    params = tmodel.init_lm(cfg, generator=torch.Generator().manual_seed(0),
                            device="cpu")
    tokens = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 8), dtype=np.int32))
    tseen = _record(monkeypatch, (tll, tmodel, tm, tr, ts, ttf),
                    tshd.constrain)
    want, pinned = _run(cfg, params, tokens, tseen)
    mesh = _host_mesh()
    try:
        assert mesh.device_mesh is not None and mesh.size == 1
        with tshd.use_mesh(mesh):
            got, _ = _run(cfg, params, tokens, tseen)
    finally:
        dist.destroy_process_group()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g, w)

    jcfg = jconfigs.get_smoke_config(arch)
    jseen = _record(monkeypatch, (jl, jmodel, jmoe, jr, js, jtf),
                    jshd.constrain)
    jparams = jax.eval_shape(lambda: jmodel.init_lm(jax.random.PRNGKey(0),
                                                    jcfg))
    jtok = jax.numpy.asarray(tokens.numpy())
    b, ecfg = tokens.shape[0], jcfg.replace(kv_pq=False)
    jax.eval_shape(lambda p: jmodel.forward(p, jtok, jcfg), jparams)
    assert pinned["forward"] == _pinned(jseen) != set()
    jseen.clear()
    jax.eval_shape(lambda p: jmodel.decode_step(
        p, jmodel.init_cache(ecfg, b, 8), jtok[:, 0],
        jax.numpy.zeros((b,), jax.numpy.int32), ecfg), jparams)
    assert pinned["decode"] == _pinned(jseen) != set()


def test_a_training_step_under_a_one_rank_mesh_is_bit_for_bit():
    from repro_torch.data import tokens as ttok
    from repro_torch.train import train_loop
    cfg = tconfigs.get_smoke_config("qwen3-1.7b")
    pipe = ttok.TokenPipelineConfig(vocab=cfg.vocab, seq_len=16,
                                    global_batch=2, seed=0)
    batch = dict(ttok.batch_at_step(pipe, 0, "cpu")._asdict())
    step = train_loop.make_train_step(cfg, topt.AdamWConfig(total_steps=4),
                                      1)

    def one():
        state = train_loop.init_train_state(cfg, 0, "cpu")
        state, metrics = step(state, batch)
        return [metrics["loss"], *state.params.parameters(),
                *state.opt.mu.values(), *state.opt.nu.values()]

    want = one()
    mesh = _host_mesh()
    try:
        with tshd.use_mesh(mesh):
            got = one()
    finally:
        dist.destroy_process_group()
    for g, w in zip(got, want, strict=True):
        assert torch.equal(g, w)


# ---------------------------------------------------------------------------
# the dry-run on the pod meshes
# ---------------------------------------------------------------------------

def _ref_bytes(sds, shardings) -> tuple[int, int, int]:
    """(bytes of one device's shards, leaves no axis shards, their bytes)
    over a reference tree and its shardings (a stacked leaf is one leaf
    here and a leaf a layer in the port, so only bytes are compared)."""
    total = whole = whole_bytes = 0
    for s, sh in zip(jax.tree.leaves(sds), jax.tree.leaves(shardings),
                     strict=True):
        nbytes = int(np.prod(sh.shard_shape(s.shape))) * s.dtype.itemsize
        total += nbytes
        if all(e is None for e in sh.spec):
            whole += 1
            whole_bytes += nbytes
    return total, whole, whole_bytes


def _ref_per_device(arch: str, shape: str, mesh: dict) -> dict:
    """The reference's ``build_cell`` shardings summed by role."""
    jd = _jdry()
    cfg = jconfigs.get_config(arch)
    kind = jd.SHAPES[shape][2]
    _, specs, shardings = jd.build_cell(cfg, shape, _jmesh(mesh))
    if kind == "train":
        (state, batch), (sstate, sbatch) = specs, shardings
        roles = {"param": (state.params, sstate.params),
                 "opt": (state.opt, sstate.opt), "batch": (batch, sbatch)}
    elif kind == "prefill":
        roles = {"param": (specs[0], shardings[0]),
                 "batch": (specs[1], shardings[1])}
        if len(specs) == 3:
            roles["cache"] = (specs[2], shardings[2])
    else:
        roles = {"param": (specs[0], shardings[0]),
                 "cache": (specs[1], shardings[1]),
                 "batch": (specs[2:], shardings[2:])}
    out = {f"{r}_bytes": 0 for r in ("param", "opt", "cache", "batch")}
    whole_bytes = 0
    for role, (s, sh) in roles.items():
        out[f"{role}_bytes"], _, nbytes = _ref_bytes(s, sh)
        whole_bytes += nbytes
    out.update(replicated_bytes=whole_bytes,
               static_bytes=out["param_bytes"] + out["opt_bytes"]
               + out["cache_bytes"],
               rules={k: v for k, v in jd.cell_rules(cfg, shape,
                                                     _jmesh(mesh)).items()
                      if jshd.DEFAULT_RULES.get(k) != v})
    return out


@pytest.mark.parametrize("mesh", tdry.POD_MESHES)
@pytest.mark.parametrize("shape", list(tdry.SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_run_cell_per_device_bytes_are_the_references(arch, shape, mesh,
                                                      tmp_path):
    jd = _jdry()
    ok, why = jd.cell_supported(jconfigs.get_config(arch), shape)
    cfg = tconfigs.get_config(arch)
    if ok:
        # run_cell counts the cell over ranks too (a prefill_32k cell
        # about a minute; test_torch_mesh_count.py): its sizing alone here
        r = tdry.size_pod_cell(cfg, shape, mesh)[2]
    else:
        r = tdry.run_cell(arch, shape, mesh=mesh, out_dir=str(tmp_path),
                          verbose=False)
        assert os.listdir(tmp_path) == [f"{arch}_{shape}_{mesh}.json"]
    if not ok:
        assert r["status"] == "skipped" and r["reason"] == why
        return
    prod = tmesh.make_production_mesh(multi_pod=mesh == "multipod")
    assert r["status"] == "ok" and r["chips"] == prod.size
    pd, want = r["per_device"], _ref_per_device(arch, shape, prod.shape)
    for key, value in want.items():
        assert pd[key] == value, key
    assert pd["fits"] == (pd["static_bytes"] <= tdry.rl.HBM_BYTES)


# (param GB, replicated GB, cache GB) of decode_32k and (param + opt GB)
# of train_4k per device on the (16, 16) pod, the reference's rules
POD_TABLE = {
    "qwen3-1.7b": ("0.03 + 0.12", "0.48", "0.24", "1.88"),
    "qwen1.5-32b": ("1.06 + 4.25", "4.40", "0.00", "2.69"),
    "dbrx-132b": ("1.09 + 4.35", "1.09", "0.00", "2.68"),
    "llama4-scout-17b-a16e": ("1.20 + 4.79", "0.84", "0.00", "3.22"),
    "nemotron-4-15b": ("0.17 + 0.68", "2.71", "0.81", "2.15"),
    "musicgen-medium": ("0.06 + 0.26", "0.17", "0.00", "4.83"),
    "rwkv6-3b": ("0.06 + 0.23", "0.90", "0.55", "0.17"),
}


def test_the_pod_table():
    rules = {}
    for arch, (train, params, whole, cache) in POD_TABLE.items():
        cfg = tconfigs.get_config(arch)
        t = tdry.size_pod_cell(cfg, "train_4k", "pod")[2]
        d = tdry.size_pod_cell(cfg, "decode_32k", "pod")[2]
        t, pd = t["per_device"], d["per_device"]
        gb = lambda n: f"{n / 1e9:.2f}"  # noqa: E731
        assert f"{gb(t['param_bytes'])} + {gb(t['opt_bytes'])}" == train
        assert (gb(pd["param_bytes"]), gb(pd["replicated_bytes"]),
                gb(pd["cache_bytes"])) == (params, whole, cache), arch
        rules[arch] = pd["rules"]
    # dbrx keeps FSDP on serving (its bf16 params / 16 pass 12 GB); the
    # others replicate "embed"; 40 heads on 16 shard head_dim, and the PQ
    # cache pq_m in place of kv_seq
    assert rules["dbrx-132b"] == {} and rules["qwen3-1.7b"] == {
        "embed": None}
    assert rules["qwen1.5-32b"] == {"embed": None, "head_dim": "model",
                                    "pq_m": "model", "kv_seq": None}

"""Carry an index across as plain numpy arrays.

The dict has the keys the reference's snapshot writes for a single-host
engine: ``codes``, ``ids``, ``sizes``, optional ``attrs`` (the list store),
``centroids``, ``codebook`` (the (M, 16, dsub) codewords) and optional
``base`` / ``base_norms``, ``ns_member`` (the (n_ns, nlist) bool
namespace table) and, while the store holds tombstones, ``live_bits`` (the
packed live-row bitmap). An index built or mutated by ``repro`` reaches
the port through this dict, and ``arrays_from_engine`` writes the same dict
back.

A coarse quantizer crosses as arrays too (``coarse_from_arrays`` /
``arrays_from_coarse``, and inside the engine's dict): an HNSW graph as
``hnsw_vectors``, ``hnsw_level0``, ``hnsw_entry`` and, for each upper level
l = 1, 2, ..., ``hnsw_ids_<l>`` and ``hnsw_adj_<l>``; a k-means tree as
``tree_roots``, ``tree_children`` and ``tree_centroids``. Without these keys
an engine gets the flat quantizer.

A flat fast-scan index (``core.fastscan.FastScanIndex``) crosses as
``codewords`` ((M, 16, dsub) f32), ``packed_codes`` ((N, M//2) u8) and
``n``: ``fastscan_index_from_arrays`` / ``arrays_from_fastscan_index``.

An LM's parameters cross as the reference's parameter tree flattened to
``/``-joined path keys (``embedding``, ``ln_f``, ``lm_head``,
``stack/blocks/attn/wq``, ``stack/group_in/w``, ... each stacked list, the
blocks and the hybrid's ``group_in``, with its leading layer axis; an MoE
block's ``stack/blocks/moe/router`` (L, D, E), ``moe/wi_gate``,
``moe/wi_up`` or ``moe/wi`` (L, E, D, F), ``moe/wo`` (L, E, F, D) and the
shared expert's ``moe/shared_*``): ``lm_params_from_arrays`` /
``arrays_from_lm_params``. A training state (parameters, AdamW moments
and step, the codec's error state) crosses under the names its checkpoint
gives it (``.params/embedding``, ``.opt/.step``, ``.opt/.mu/...``):
``train_state_from_arrays`` / ``arrays_from_train_state``. A PQ KV cache
crosses as ``k_codes``, ``v_codes`` (u8) and ``k_cb``, ``v_cb`` (the
codebooks): ``pq_cache_from_arrays`` / ``arrays_from_pq_cache``. The
recurrent families' caches cross under the reference's dict keys (Mamba2
``h``, ``conv`` and the hybrid's ``attn_k``/``attn_v`` or
``attn_k_codes``/``attn_v_codes``/``attn_k_cb``/``attn_v_cb``; RWKV6 ``s``,
``tm_prev``, ``cm_prev``): ``lm_cache_from_arrays`` /
``arrays_from_lm_cache``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import coarse as coarse_mod
from repro_torch.core.fastscan import FastScanIndex
from repro_torch.core.hnsw import HNSWGraph
from repro_torch.core.ivf import IVFIndex
from repro_torch.core.lists import store_arrays, store_from_arrays
from repro_torch.core.pq import PQCodebook
from repro_torch.device import resolve_device
from repro_torch.engine.engine import EngineConfig, SearchEngine
from repro_torch.models import layers as ll
from repro_torch.models import model as model_lib
from repro_torch.models.config import ModelConfig
from repro_torch.models.kvcache import PQKVCache
from repro_torch.train.optimizer import AdamWState
from repro_torch.train.train_loop import TrainState


def _f32(arrays: dict, key: str, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.array(arrays[key], np.float32)).to(dev)


def _i32(arrays: dict, key: str, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.array(arrays[key], np.int32)).to(dev)


def coarse_from_arrays(arrays: dict[str, np.ndarray],
                       device: str | torch.device | None = None):
    """The HNSW or tree quantizer the dict carries, on ``device`` (None =
    the CUDA card), or None when it carries neither."""
    dev = resolve_device(device)
    if "hnsw_level0" in arrays:
        uppers, lvl = [], 1
        while f"hnsw_ids_{lvl}" in arrays:
            uppers.append((_i32(arrays, f"hnsw_ids_{lvl}", dev),
                           _i32(arrays, f"hnsw_adj_{lvl}", dev)))
            lvl += 1
        return coarse_mod.HNSWCoarse(HNSWGraph(
            vectors=_f32(arrays, "hnsw_vectors", dev),
            level0=_i32(arrays, "hnsw_level0", dev), uppers=tuple(uppers),
            entry=int(arrays["hnsw_entry"])))
    if "tree_roots" in arrays:
        return coarse_mod.TreeCoarse(
            roots=_f32(arrays, "tree_roots", dev),
            children=_i32(arrays, "tree_children", dev),
            centroids=_f32(arrays, "tree_centroids", dev))
    return None


def arrays_from_coarse(coarse) -> dict[str, np.ndarray]:
    """The inverse: an HNSW or tree quantizer as host arrays; a flat one
    gives an empty dict (the index's centroids are the whole of it)."""
    if isinstance(coarse, coarse_mod.HNSWCoarse):
        g = coarse.graph
        out = {"hnsw_vectors": g.vectors.cpu().numpy(),
               "hnsw_level0": g.level0.cpu().numpy(),
               "hnsw_entry": np.asarray(g.entry, np.int64)}
        for lvl, (ids, adj) in enumerate(g.uppers, start=1):
            out[f"hnsw_ids_{lvl}"] = ids.cpu().numpy()
            out[f"hnsw_adj_{lvl}"] = adj.cpu().numpy()
        return out
    if isinstance(coarse, coarse_mod.TreeCoarse):
        return {"tree_roots": coarse.roots.cpu().numpy(),
                "tree_children": coarse.children.cpu().numpy(),
                "tree_centroids": coarse.centroids.cpu().numpy()}
    return {}


def index_from_arrays(arrays: dict[str, np.ndarray],
                      device: str | torch.device | None = None) -> IVFIndex:
    """Rebuild an ``IVFIndex`` on ``device`` (None = the CUDA card)."""
    dev = resolve_device(device)
    return IVFIndex(centroids=_f32(arrays, "centroids", dev),
                    codebook=PQCodebook(_f32(arrays, "codebook", dev)),
                    lists=store_from_arrays(arrays, device=dev))


def engine_from_arrays(arrays: dict[str, np.ndarray], *,
                       config: EngineConfig | None = None,
                       device: str | torch.device | None = None
                       ) -> SearchEngine:
    """Rebuild a ``SearchEngine`` on ``device``, with the base and its
    norms, the namespace table, the live-row bitmap and the HNSW or tree
    quantizer when the dict carries them (else flat coarse; the engine
    derives the bitmap from the ids; a carried one is installed as it is,
    as the reference's snapshot loader does)."""
    dev = resolve_device(device)
    index = index_from_arrays(arrays, dev)
    base = _f32(arrays, "base", dev) if "base" in arrays else None
    norms = (_f32(arrays, "base_norms", dev)
             if base is not None and "base_norms" in arrays else None)
    member = (torch.from_numpy(np.array(arrays["ns_member"], bool))
              if "ns_member" in arrays else None)
    live = (torch.from_numpy(np.array(arrays["live_bits"], np.uint8))
            if "live_bits" in arrays else None)
    coarse = coarse_from_arrays(arrays, dev)
    return SearchEngine(index, base=base, config=config, base_norms=norms,
                        namespaces=member, live_bits=live,
                        coarse="flat" if coarse is None else coarse)


def arrays_from_engine(engine: SearchEngine) -> dict[str, np.ndarray]:
    """The inverse: an engine's index (and base, live-row bitmap, namespace
    table, HNSW or tree quantizer) as host arrays."""
    idx = engine.index
    out = dict(store_arrays(idx.lists))
    out["centroids"] = idx.centroids.cpu().numpy()
    out["codebook"] = idx.codebook.codewords.cpu().numpy()
    if engine.base is not None:
        out["base"] = engine.base.cpu().numpy()
        out["base_norms"] = engine.base_norms.cpu().numpy()
    if engine.live_bits is not None:
        out["live_bits"] = engine.live_bits.cpu().numpy()
    if engine.ns_member is not None:
        out["ns_member"] = engine.ns_member.cpu().numpy()
    out.update(arrays_from_coarse(engine.coarse))
    return out


def fastscan_index_from_arrays(arrays: dict[str, np.ndarray],
                               device: str | torch.device | None = None
                               ) -> FastScanIndex:
    """Rebuild a flat ``FastScanIndex`` on ``device`` (None = the CUDA
    card) from ``codewords``, ``packed_codes`` and ``n``."""
    dev = resolve_device(device)
    codes = torch.from_numpy(np.array(arrays["packed_codes"], np.uint8)
                             ).to(dev)
    return FastScanIndex(PQCodebook(_f32(arrays, "codewords", dev)), codes,
                         int(arrays["n"]))


def arrays_from_fastscan_index(index: FastScanIndex) -> dict[str, np.ndarray]:
    """The inverse: a flat index as host arrays."""
    return {"codewords": index.codebook.codewords.cpu().numpy(),
            "packed_codes": index.packed_codes.cpu().numpy(),
            "n": np.asarray(index.n, np.int64)}


def _named_from_arrays(arrays: dict[str, np.ndarray], named,
                       dev: torch.device) -> dict[str, torch.Tensor]:
    """For each (dotted name, like) of ``named``, its layer of the array
    under its path key, read through f32, as an f32 tensor on ``dev``.
    Every key must be used."""
    out, used = {}, set()
    for name, like in named:
        key, layer = ll.tree_key(name)
        if key not in arrays:
            raise KeyError(f"{key} missing from the arrays")
        a = np.asarray(arrays[key], np.float32)
        a = a[layer] if layer is not None else a
        if a.shape != tuple(like.shape):
            raise ValueError(f"{key}: shape {a.shape}, want "
                             f"{tuple(like.shape)}")
        out[name] = torch.from_numpy(np.array(a)).to(dev)
        used.add(key)
    extra = sorted(set(arrays) - used)
    if extra:
        raise KeyError(f"arrays the config has no parameter for: {extra}")
    return out


def _arrays_from_named(named) -> dict[str, np.ndarray]:
    """(dotted name, tensor) pairs as f32 host arrays under their path
    keys, a parameter of every layer stacked on a leading layer axis."""
    stacks: dict[str, list] = {}
    out = {}
    for name, t in named:
        key, layer = ll.tree_key(name)
        a = t.detach().float().cpu().numpy()
        if layer is None:
            out[key] = a
        else:
            stacks.setdefault(key, []).append((layer, a))
    for key, layers in stacks.items():
        out[key] = np.stack([a for _, a in sorted(layers, key=lambda x: x[0])])
    return out


def lm_params_from_arrays(arrays: dict[str, np.ndarray], cfg: ModelConfig,
                          device: str | torch.device | None = None,
                          dtype: torch.dtype | None = None) -> ll.Params:
    """The model of ``cfg`` on ``device`` (None = the CUDA card) in
    ``dtype`` (None = the config's) holding the reference's parameters: a
    dict of path keys to arrays (any float dtype, read through f32), the
    stacked blocks with their leading layer axis. Every key must be used."""
    dev = resolve_device(device)
    specs = model_lib.lm_specs(cfg)
    model = ll.Params(specs, dtype=dtype or model_lib.model_dtype(cfg),
                      device=dev)
    named = list(model.named_parameters())
    with torch.no_grad():
        for name, t in _named_from_arrays(arrays, named, dev).items():
            model.get_parameter(name).copy_(t)
    return model


def arrays_from_lm_params(model: ll.Params) -> dict[str, np.ndarray]:
    """The inverse: every parameter as an f32 host array under its path
    key, the blocks stacked on a leading layer axis."""
    return _arrays_from_named(model.named_parameters())


def _under(arrays: dict[str, np.ndarray], prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in arrays.items()
            if k.startswith(prefix)}


def train_state_from_arrays(arrays: dict[str, np.ndarray], cfg: ModelConfig,
                            device: str | torch.device | None = None,
                            dtype: torch.dtype | None = None) -> TrainState:
    """A training state on ``device`` (None = the CUDA card) from host
    arrays under the checkpoint's names (``.params/...``, ``.opt/.step``,
    ``.opt/.mu/...``, ``.opt/.nu/...`` and ``.ef_error/...`` when
    present; the reference's ``TrainState`` flattened as its checkpoint
    flattens it): the parameters, trainable, in ``dtype`` (None = the
    config's), the moments and the error state in f32, the step int32."""
    dev = resolve_device(device)
    params = ll.set_trainable(lm_params_from_arrays(
        _under(arrays, ".params/"), cfg, dev, dtype))
    named = list(params.named_parameters())

    def tree(prefix):
        return _named_from_arrays(_under(arrays, prefix), named, dev)

    step = torch.tensor(int(np.asarray(arrays[".opt/.step"])),
                        dtype=torch.int32, device=dev)
    ef = tree(".ef_error/") if _under(arrays, ".ef_error/") else None
    return TrainState(params, AdamWState(step, tree(".opt/.mu/"),
                                         tree(".opt/.nu/")), ef)


def arrays_from_train_state(state: TrainState) -> dict[str, np.ndarray]:
    """The inverse: f32 host arrays (the step int32) under the
    checkpoint's names."""
    out = {f".params/{k}": v
           for k, v in arrays_from_lm_params(state.params).items()}
    out[".opt/.step"] = np.asarray(state.opt.step.item(), np.int32)
    trees = {".opt/.mu/": state.opt.mu, ".opt/.nu/": state.opt.nu,
             ".ef_error/": state.ef_error or {}}
    for prefix, tree in trees.items():
        out.update({prefix + k: v
                    for k, v in _arrays_from_named(tree.items()).items()})
    return out


def pq_cache_from_arrays(arrays: dict[str, np.ndarray],
                         device: str | torch.device | None = None
                         ) -> PQKVCache:
    """A PQ KV cache on ``device`` (None = the CUDA card): ``k_codes`` and
    ``v_codes`` (L, B, Smax, KV, M//2) u8, ``k_cb`` and ``v_cb`` (L, KV, M,
    16, dsub) read through f32 and held in bf16, as calibration makes
    them."""
    dev = resolve_device(device)

    def codes(key):
        return torch.from_numpy(np.array(arrays[key], np.uint8)).to(dev)

    def cb(key):
        return _f32(arrays, key, dev).to(torch.bfloat16)

    return PQKVCache(codes("k_codes"), codes("v_codes"), cb("k_cb"),
                     cb("v_cb"))


def arrays_from_pq_cache(cache: PQKVCache) -> dict[str, np.ndarray]:
    """The inverse: codes as u8 and codebooks as f32 host arrays."""
    return {"k_codes": cache.k_codes.cpu().numpy(),
            "v_codes": cache.v_codes.cpu().numpy(),
            "k_cb": cache.k_cb.float().cpu().numpy(),
            "v_cb": cache.v_cb.float().cpu().numpy()}


# the recurrent caches' f32 states and u8 codes; codebooks are bf16, the
# rest in the model's dtype
_F32_STATES = ("h", "s")
_CODES = ("attn_k_codes", "attn_v_codes")
_CODEBOOKS = ("attn_k_cb", "attn_v_cb")


def lm_cache_from_arrays(arrays: dict[str, np.ndarray], cfg: ModelConfig,
                         device: str | torch.device | None = None,
                         dtype: torch.dtype | None = None) -> dict:
    """A Mamba2 / hybrid or RWKV6 decode cache on ``device`` (None = the
    CUDA card) under the reference's keys: ``h`` and ``s`` in f32, codes in
    u8, codebooks read through f32 and held in bf16 (as calibration makes
    them), the rest in ``dtype`` (None = the config's)."""
    dev = resolve_device(device)
    dtype = dtype or model_lib.model_dtype(cfg)
    out = {}
    for key, a in arrays.items():
        if key in _CODES:
            out[key] = torch.from_numpy(np.array(a, np.uint8)).to(dev)
        else:
            t = _f32(arrays, key, dev)
            out[key] = t if key in _F32_STATES else t.to(
                torch.bfloat16 if key in _CODEBOOKS else dtype)
    return out


def arrays_from_lm_cache(cache: dict) -> dict[str, np.ndarray]:
    """The inverse: codes as u8, everything else as f32 host arrays."""
    return {key: (t.cpu().numpy() if t.dtype == torch.uint8
                  else t.float().cpu().numpy()) for key, t in cache.items()}
